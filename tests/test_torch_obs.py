"""Port parity: repro_torch.obs against the contracts of tests/test_obs.py and
against the reference's own exports (CPU).

The mirror block repeats every test of tests/test_obs.py on the port: the
zero-sync identity (tokens, host syncs and admissions equal with an observer
on or off, on every decode driver), the ring, the exporters and their atomic
writes, the SLO math, the injectable clock, the WaveRecord shim and the
tuner's spans.  The cross-package block serves one model in both packages:
the reference's tiny W1A3 p=4 dequant tree, prepared and carried into the
port with ``convert.params_from_numpy``.  Under ``FakeClock(tick=0.0)`` every
timestamp is 0, so the two packages' Perfetto and metrics files must be the
same bytes; under a ticking clock the event streams must match event for
event.
"""

import dataclasses as dc
import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro import timing as jtiming  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.ft import supervisor as jsup  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.ops import LiveServer as JLiveServer  # noqa: E402
from repro.serve.ops import SwapController as JSwapController  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import timing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.ft import supervisor as sup  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    Observer,
    Tracer,
    percentile,
    scrape_engine,
    slo_stats,
    snapshot_text,
    write_jsonl,
    write_metrics_jsonl,
    write_perfetto,
)
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Event  # noqa: E402
from repro_torch.serve.ops import LiveServer, SwapController  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine, WaveRecord  # noqa: E402

DECODES = ["scan", "chunked", "loop"]
TINY = dict(name="obs-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
            vocab_size=64)


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny decoder quantized at the fig13 default serve
    config (W1A3, p=4, dequant numerics: batch-composition invariant,
    replay-exact), prepared, and the same tree carried into the port."""
    jcfg = dc.replace(jget_config("stablelm-12b", smoke=True), **TINY)
    cfg = dc.replace(get_config("stablelm-12b", smoke=True), **TINY)
    jm = jbuild(jcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=4, mode="dequant"))
    jp = jm.prepare(jq)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return dict(cfg=cfg, model=build_model(cfg), tree=tree, jm=jm, jp=jp)


def _reqs(cfg, budgets=(6, 2, 4, 2), seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size, 3 + i).astype(np.int32),
                max_new_tokens=m) for i, m in enumerate(budgets)]


def _engine(t, **kw):
    return ServeEngine(t["model"], t["tree"], batch=2, max_seq=32, device="cpu", **kw)


def _jengine(t, **kw):
    return JServeEngine(t["jm"], t["jp"], batch=2, max_seq=32, **kw)


def _python_scalars(v) -> bool:
    if isinstance(v, (list, tuple)):
        return all(_python_scalars(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _python_scalars(x) for k, x in v.items())
    return v is None or type(v) in (bool, int, float, str)


# --- the zero-sync contract ------------------------------------------------


@pytest.mark.parametrize("decode", DECODES)
def test_tracing_is_invisible_to_tokens_syncs_and_admissions(tiny, decode):
    """Tokens, host_syncs, admission order and bucket counts equal with
    tracing on and off, on every decode driver, and equal to the reference's
    tokens; every request observed through its full lifecycle; every event
    arg a Python scalar (a numpy or torch one would break the export)."""
    reqs = _reqs(tiny["cfg"])
    plain = _engine(tiny, decode=decode)
    want = plain.generate(reqs)
    assert want == _jengine(tiny, decode=decode).generate(_reqs(tiny["cfg"], cls=JRequest))

    obs = Observer()
    traced = _engine(tiny, decode=decode, obs=obs)
    got = traced.generate(reqs)
    assert got == want
    assert traced.host_syncs == plain.host_syncs
    assert traced.admissions == plain.admissions
    assert traced.bucket_counts == plain.bucket_counts
    assert len(obs.tracer) > 0
    recs = obs.request_records()
    assert len(recs) == len(reqs)
    for r in recs:
        assert r["done"] is not None and r["first"] is not None
        assert r["tokens"] == reqs[r["key"][1]].max_new_tokens
    assert all(_python_scalars(e.args) for e in obs.tracer.events())
    assert obs.slo()["completed"] == len(reqs)


def test_wave_spans_record_existing_sync_timestamps(tiny):
    """Continuous-driver wave spans: one wave span + one host_sync span per
    admission wave, complete spans with non-negative durations."""
    obs = Observer()
    eng = _engine(tiny, obs=obs)
    eng.generate(_reqs(tiny["cfg"]))
    waves = [e for e in obs.tracer.events() if e.cat == "wave" and e.name.startswith("wave ")]
    syncs = [e for e in obs.tracer.events() if e.name == "host_sync"]
    assert len(waves) == eng.host_syncs == len(syncs)
    for e in waves:
        assert e.ph == "X" and e.dur >= 0


@pytest.mark.parametrize("decode", ["chunked", "loop"])
def test_chunk_drivers_record_one_coarse_wave_per_chunk(tiny, decode):
    """The chunked and loop drivers give obs one record per chunk (their
    on_wave stays silent, as the reference's), every request of the chunk
    admitted and finished in it."""
    obs = Observer()
    eng = _engine(tiny, decode=decode, obs=obs)
    seen = []
    eng.on_wave = seen.append
    reqs = _reqs(tiny["cfg"])
    eng.generate(reqs)
    waves = [e for e in obs.tracer.events() if e.cat == "wave" and e.name.startswith("wave ")]
    assert [e.name for e in waves] == ["wave 0", "wave 1"] and not seen
    assert obs.metrics.snapshot()["counters"]["admissions"] == len(reqs)
    life = [e for e in obs.tracer.events() if e.name.endswith("lifecycle")]
    assert sorted(e.args["request"] for e in life) == list(range(len(reqs)))


# --- WaveRecord + legacy shim ---------------------------------------------


def test_on_wave_delivers_structured_record(tiny):
    eng = _engine(tiny)
    seen = []
    eng.on_wave = seen.append
    want = eng.generate(_reqs(tiny["cfg"]))
    assert seen and all(isinstance(r, WaveRecord) for r in seen)
    assert [r.wave for r in seen] == list(range(len(seen)))
    emitted = sum(len(t) for r in seen for _i, _s, t in r.emitted)
    assert emitted == sum(len(o) for o in want)
    fin = sorted(i for r in seen for i in r.finished)
    assert fin == list(range(len(want)))
    for r in seen:
        assert r.t_start <= r.t_decode <= r.t_fetch <= r.t_sync
        assert r.sync_s == r.t_sync - r.t_fetch


def test_legacy_positional_on_wave_still_works_with_deprecation(tiny):
    eng = _engine(tiny)
    calls = []

    def legacy(wave, admitted, emitted):
        calls.append((wave, admitted, emitted))

    eng.on_wave = legacy
    with pytest.warns(DeprecationWarning, match="WaveRecord"):
        eng.generate(_reqs(tiny["cfg"]))
    assert calls
    wave0, admitted0, emitted0 = calls[0]
    assert wave0 == 0 and isinstance(admitted0, list)
    assert all(isinstance(t, list) for _i, _s, t in emitted0)


def test_star_args_on_wave_treated_as_legacy(tiny):
    eng = _engine(tiny)
    shapes = []
    eng.on_wave = lambda *a: shapes.append(len(a))
    with pytest.warns(DeprecationWarning):
        eng.generate(_reqs(tiny["cfg"]))
    assert shapes and all(n == 3 for n in shapes)


def test_obs_records_the_wave_before_a_crash_in_on_wave(tiny):
    """obs records first: a crash injected through on_wave at wave 1 still
    leaves waves 0 and 1 traced, and generate's finally still ends the
    serve (``serve done``)."""
    obs = Observer()
    eng = _engine(tiny, obs=obs)
    inj = sup.FailureInjector(fail_at_waves=(1,))
    eng.on_wave = lambda rec: inj.maybe_fail_wave(rec.wave)
    with pytest.raises(sup.InjectedFailure):
        eng.generate(_reqs(tiny["cfg"]))
    names = [e.name for e in obs.tracer.events()]
    assert "wave 0" in names and "wave 1" in names and names[-1] == "serve done"


# --- tracer ring -----------------------------------------------------------


def test_ring_buffer_caps_memory_and_counts_drops():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}", ts=float(i))
    assert len(tr) == 4
    assert tr.dropped == 6
    assert [e.name for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0
    with pytest.raises(ValueError):
        Tracer(capacity=0)


# --- exporters -------------------------------------------------------------


def test_perfetto_export_loads_and_has_request_lifecycle_spans(tiny, tmp_path):
    obs = Observer()
    _engine(tiny, obs=obs).generate(_reqs(tiny["cfg"]))
    path = tmp_path / "trace.json"
    write_perfetto(obs, str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    tracks = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "engine" in tracks and "slot 0" in tracks
    life = [e for e in evs if e["ph"] == "X" and "lifecycle" in e["name"]]
    assert len(life) == 4
    for e in life:
        assert e["dur"] >= 0 and "ts" in e
    assert list(tmp_path.iterdir()) == [path]     # no tmp residue


def test_jsonl_and_metrics_exports(tiny, tmp_path):
    obs = Observer()
    _engine(tiny, obs=obs).generate(_reqs(tiny["cfg"]))
    ev_path = write_jsonl(obs, str(tmp_path / "events.jsonl"))
    with open(ev_path) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == len(obs.tracer)
    m_path = write_metrics_jsonl(obs, str(tmp_path / "metrics.jsonl"), extra={"run": 1})
    with open(m_path) as f:
        recs = [json.loads(ln) for ln in f]
    kinds = [r["t"] for r in recs]
    assert kinds[0] == "snapshot" and kinds[1] == "slo"
    assert kinds.count("request") == 4 and kinds[-1] == "extra"
    snap = recs[0]
    assert snap["counters"]["tokens_emitted"] == 14
    assert snap["counters"]["requests_finished"] == 4
    text = snapshot_text(obs)
    assert "goodput" in text and "ttft" in text


@pytest.mark.parametrize("bad", [{1, 2}, np.int64(3), torch.tensor(3)],
                         ids=["set", "numpy", "torch"])
def test_atomic_export_preserves_previous_file_on_failure(tmp_path, bad):
    """A failed export leaves the previous file whole and no tmp file; a
    numpy or torch scalar arg fails the export as a set does."""
    path = tmp_path / "trace.json"
    good = Tracer()
    good.instant("ok", ts=0.0)
    write_perfetto(good, str(path))
    before = path.read_text()
    bad_tr = Tracer()
    bad_tr.emit(Event(name="bad", ts=0.0, args={"x": bad}))
    with pytest.raises(TypeError):
        write_perfetto(bad_tr, str(path))
    assert path.read_text() == before
    assert list(tmp_path.iterdir()) == [path]


# --- chaos point: trace survives a kill ------------------------------------


def test_trace_survives_mid_serve_kill_with_no_torn_file(tiny, tmp_path):
    """A kill mid-serve leaves a complete, loadable Perfetto file (the
    attempt-boundary atomic re-export), and the replayed serve gives the
    undisturbed tokens with live-ops events on the supervisor track."""
    reqs = _reqs(tiny["cfg"])
    want = _engine(tiny).generate(reqs)
    obs = Observer()
    trace_path = tmp_path / "live_trace.json"
    server = LiveServer(lambda: _engine(tiny), log_path=str(tmp_path / "serve.jsonl"),
                        injector=sup.FailureInjector(fail_at_waves=(1,)),
                        obs=obs, trace_path=str(trace_path))
    got = server.serve(reqs)
    assert got == want and server.restarts == 1
    names = [e["name"] for e in json.loads(trace_path.read_text())["traceEvents"]]
    assert "restart" in names and "replay" in names
    sup_events = [e for e in obs.tracer.events() if e.track == "supervisor"]
    assert {"replay", "restart"} <= {e.name for e in sup_events}
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


# --- metrics + SLO math ----------------------------------------------------


def test_percentile_nearest_rank():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 99) == 5.0
    assert percentile(xs, 0) == 1.0
    assert math.isnan(percentile([], 50))


def test_histogram_buckets_and_stats():
    h = Histogram(buckets=[0.1, 1.0])
    for v in (0.05, 0.5, 2.0, 3.0):
        h.observe(v)
    assert h.count == 4 and h.min == 0.05 and h.max == 3.0
    assert h.to_dict()["buckets"] == [[0.1, 1], [1.0, 1], ["+inf", 2]]
    r = MetricsRegistry()
    assert r.counter("c") is r.counter("c")
    r.counter("c").inc(2)
    r.gauge("g").set(7)
    snap = r.snapshot()
    assert snap["counters"]["c"] == 2 and snap["gauges"]["g"] == 7


def test_slo_stats_from_lifecycle_records():
    recs = [
        # ttft 2, queue wait 1, tpot (6-2)/4 = 1
        dict(submit=0.0, admit=1.0, first=2.0, done=6.0, tokens=5),
        # unfinished: counts for ttft / queue wait, not for goodput
        dict(submit=0.0, admit=3.0, first=4.0, done=None, tokens=2),
    ]
    s = slo_stats(recs)
    assert s["requests"] == 2 and s["completed"] == 1
    assert s["ttft"]["p50_s"] == 2.0 and s["ttft"]["max_s"] == 4.0
    assert s["queue_wait"]["p99_s"] == 3.0
    assert s["tpot"]["p50_s"] == 1.0
    assert s["goodput"]["completed_tokens"] == 5
    assert s["goodput"]["wall_s"] == 6.0
    assert s["goodput"]["tokens_per_s"] == pytest.approx(5 / 6.0)
    none_done = slo_stats([dict(submit=0.0, admit=None, first=None, done=None, tokens=0)])
    assert none_done["goodput"]["tokens_per_s"] == 0.0


def test_slo_math_equals_reference_on_random_records():
    """percentile, slo_stats and a histogram's dict are the reference's on
    the same seeded samples (the SLO numbers the benchmark will read)."""
    rng = np.random.default_rng(4)
    xs = [float(v) for v in rng.exponential(0.2, 37)]
    for q in (0, 1, 50, 90, 99, 100):
        assert percentile(xs, q) == jobs.percentile(xs, q)
    recs = []
    for i in range(23):
        sub = float(rng.uniform(0, 1))
        adm = sub + float(rng.exponential(0.1))
        first = adm + float(rng.exponential(0.3))
        done = None if i % 5 == 4 else first + float(rng.exponential(1.0))
        recs.append(dict(submit=sub, admit=adm, first=first, done=done,
                         tokens=int(rng.integers(1, 20))))
    assert json.dumps(slo_stats(recs)) == json.dumps(jobs.slo_stats(recs))
    h, jh = Histogram(), jobs.Histogram()
    for v in xs:
        h.observe(v)
        jh.observe(v)
    assert h.to_dict() == jh.to_dict()


def test_scrape_engine_gauges_from_existing_structures(tiny):
    eng = _engine(tiny)
    eng.generate(_reqs(tiny["cfg"]))
    m = MetricsRegistry()
    out = scrape_engine(eng, metrics=m)
    assert out["batch_slots"] == 2 and out["decode"] == "scan"
    assert out["host_syncs"] == eng.host_syncs > 0
    assert out["prefill_buckets"]
    assert sum(out["prefill_buckets"].values()) >= 1
    assert m.snapshot()["gauges"]["host_syncs"] == eng.host_syncs


def test_scrape_engine_plan_gauges_equal_the_plan_and_the_reference():
    """Under ServeEngine(plan=) the plan gauges (layers, bytes, the mode and
    p mix) are what plan.layers gives, and equal the reference's scrape of
    its engine under the same plan."""
    from repro.tune import planner as jplanner
    from repro_torch.tune import planner as tplanner

    kw = dict(TINY, name="tune-test")
    jcfg = dc.replace(jget_config("stablelm-12b", smoke=True), **kw)
    cfg = dc.replace(get_config("stablelm-12b", smoke=True), **kw)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    pkw = dict(lut_budget_bytes=1 << 22, n_hint=2, measure=False, p_cap=4)
    jplan, plan = jplanner.plan_model(jq, **pkw), tplanner.plan_model(tq, **pkw)
    eng = ServeEngine(tm, tq, batch=2, max_seq=32, plan=plan, device="cpu")
    m = MetricsRegistry()
    got = scrape_engine(eng, metrics=m)["plan"]
    modes, ps = {}, {}
    for lp in plan.layers.values():
        modes[lp.mode] = modes.get(lp.mode, 0) + 1
        ps[str(lp.p)] = ps.get(str(lp.p), 0) + 1
    assert got == dict(layers=len(plan.layers), budget_bytes=plan.budget_bytes,
                       total_bytes=plan.total_bytes, modes=modes, p=ps)
    assert "2" not in ps                        # the plan re-tunes the base p = 2
    gauges = m.snapshot()["gauges"]
    assert (gauges["plan_layers"], gauges["plan_total_bytes"]) == (len(plan.layers),
                                                                   plan.total_bytes)
    jeng = JServeEngine(jm, jq, batch=2, max_seq=32, plan=jplan)
    assert got == jobs.scrape_engine(jeng)["plan"]


def test_scrape_engine_stream_ratios_equal_the_reference():
    """A stream-mode tree's buffer-hit ratios (the planner on a seeded
    sample, no GEMM) equal the reference's, leaf for leaf."""
    jcfg = dc.replace(jget_config("stablelm-12b", smoke=True), **TINY)
    cfg = dc.replace(get_config("stablelm-12b", smoke=True), **TINY)
    jm = jbuild(jcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="stream"))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    got = scrape_engine(ServeEngine(build_model(cfg), tq, batch=2, max_seq=32, device="cpu"),
                        stream_sample_n=16)["stream_buffer_hit_ratio"]
    want = jobs.scrape_engine(JServeEngine(jm, jq, batch=2, max_seq=32),
                              stream_sample_n=16)["stream_buffer_hit_ratio"]
    assert got == want and len(got) == 7


# --- injectable clock ------------------------------------------------------


def test_fake_clock_and_override_steer_trace_timestamps():
    fc = timing.FakeClock(start=100.0, tick=1.0)
    assert fc() == 100.0 and fc() == 101.0
    fc.advance(10.0)
    assert fc() == 112.0
    with timing.override_clock(timing.FakeClock(start=5.0, tick=0.5)):
        tr = Tracer()
        tr.instant("a")
        tr.instant("b")
        a, b = tr.events()
        assert (a.ts, b.ts) == (5.0, 5.5)
    t0 = timing.clock()
    assert timing.clock() >= t0 >= 1e-9


def test_override_clock_restores_on_exception():
    with pytest.raises(RuntimeError):
        with timing.override_clock(lambda: 0.0):
            assert timing.clock() == 0.0
            raise RuntimeError("boom")
    assert timing.clock() != 0.0


# --- tune.measure observability -------------------------------------------


def test_measurer_emits_measurement_spans_and_hit_counters():
    from repro_torch.core import api
    from repro_torch.tune import measure as measure_mod
    from repro_torch.tune import space

    rng = np.random.default_rng(0)
    spec = api.LutLinearSpec(bw=1, ba=3, p=2, mode="lut")
    q = api.quantize_linear(torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32)), spec)
    x = measure_mod.sample_activations(12, 4, device="cpu")
    obs = Observer()
    meas = measure_mod.Measurer(iters=1, warmup=1, cache={}, obs=obs)
    c = space.Candidate(mode="lut", p=2)
    us = meas.measure(q, x, c)
    meas.measure(q, x, c)                         # cache hit
    snap = obs.metrics.snapshot()["counters"]
    assert snap["tune_measure_misses"] == meas.misses == 1
    assert snap["tune_measure_hits"] == meas.hits == 1
    spans = [e for e in obs.tracer.events() if e.cat == "tune"]
    assert len(spans) == 1 and spans[0].ph == "X"
    assert spans[0].track == "tune.measure"
    assert spans[0].name == "measure lut p=2 [8x12]" and spans[0].args["us"] == us
    assert spans[0].dur == pytest.approx(us * 1e-6)


# --- live ops ----------------------------------------------------------------


def _drifted(tree, map_leaves):
    return map_leaves(tree, lambda _p, leaf: dc.replace(leaf, spec=dc.replace(leaf.spec, bw=2)))


def _swap_events(ctrl, tree, drift, obs):
    """Stage + flip ``tree``, then try a drifting one: the swap track's
    events as (name, cat, ph, track, args)."""
    ctrl.flip(ctrl.stage(params=tree), timeout=60.0)
    with pytest.raises(ValueError, match="incompatible hot-swap refused"):
        ctrl.flip(ctrl.stage(params=drift), timeout=60.0)
    return [(e.name, e.cat, e.ph, e.track, e.args) for e in obs.tracer.events()
            if e.track == "swap"]


def test_swap_controller_records_stage_flip_and_refusal_like_the_reference(tiny):
    """SwapController(obs=) defaults to the engine's observer and records
    the stage span (from the stage's thread), the flip span and a refused
    swap's event, as the reference's does for the same swaps; the stage and
    flip durations feed ops_* histograms."""
    from repro.tune.plan import map_quantized_leaves as jmap
    from repro_torch.tune.plan import map_quantized_leaves

    obs, jobs_obs = Observer(), jobs.Observer()
    eng = _engine(tiny, obs=obs)
    ctrl = SwapController(eng)
    assert ctrl.obs is obs
    got = _swap_events(ctrl, tiny["tree"], _drifted(tiny["tree"], map_quantized_leaves), obs)
    want = _swap_events(JSwapController(_jengine(tiny, obs=jobs_obs)), tiny["jp"],
                        _drifted(tiny["jp"], jmap), jobs_obs)
    assert got == want
    assert [n for n, *_ in got] == ["swap stage", "swap flip", "swap stage", "swap refuse"]
    assert got[1][4] == {"wave": None, "swaps": 1} and got[3][4] == {"error": "ValueError"}
    snap = obs.metrics.snapshot()
    assert snap["counters"]["ops_swap"] == 1
    assert snap["histograms"]["ops_swap_s"]["count"] == 3


# --- the launcher ------------------------------------------------------------


def test_launch_serve_writes_trace_and_metrics(tmp_path):
    from repro_torch.launch import serve as launch

    trace, metrics = tmp_path / "obs" / "trace.json", tmp_path / "obs" / "metrics.jsonl"
    outs = launch.main(["--smoke", "--mode", "lut", "--calibrate", "32", "--device", "cpu",
                        "--requests", "3", "--max-new", "4", "--trace", str(trace),
                        "--metrics", str(metrics)])
    evs = json.loads(trace.read_text())["traceEvents"]
    assert sum(1 for e in evs if e["name"].endswith("lifecycle")) == len(outs) == 3
    with open(metrics) as f:
        recs = [json.loads(ln) for ln in f]
    assert recs[1]["t"] == "slo" and recs[1]["completed"] == 3
    assert sorted(p.name for p in trace.parent.iterdir()) == ["metrics.jsonl", "trace.json"]


# --- across packages -----------------------------------------------------------


def _serve_both(tiny, decode, jclock, tclock):
    """Serve the same requests in both packages, each under its own clock;
    returns the two observers."""
    jo, to = jobs.Observer(), Observer()
    with jtiming.override_clock(jclock):
        _jengine(tiny, decode=decode, obs=jo).generate(_reqs(tiny["cfg"], cls=JRequest))
    with timing.override_clock(tclock):
        _engine(tiny, decode=decode, obs=to).generate(_reqs(tiny["cfg"]))
    return jo, to


def _files_equal(jo, to, tmp_path):
    """Both packages' Perfetto and metrics files, compared byte for byte."""
    for name, jw, tw in (("trace.json", jobs.write_perfetto, write_perfetto),
                         ("metrics.jsonl", jobs.write_metrics_jsonl, write_metrics_jsonl)):
        jp, tp = tmp_path / f"ref_{name}", tmp_path / f"port_{name}"
        jw(jo, str(jp))
        tw(to, str(tp))
        assert tp.read_bytes() == jp.read_bytes(), name


@pytest.mark.parametrize("decode", DECODES)
def test_exports_byte_identical_to_reference(tiny, decode, tmp_path):
    """Under FakeClock(tick=0.0) in both packages, the same serve writes the
    same Perfetto and metrics JSONL bytes."""
    jo, to = _serve_both(tiny, decode, jtiming.FakeClock(tick=0.0), timing.FakeClock(tick=0.0))
    assert len(to.tracer) == len(jo.tracer) > 0
    _files_equal(jo, to, tmp_path)


def test_killed_live_server_exports_byte_identical_to_reference(tiny, tmp_path):
    """A LiveServer killed at wave 1 in both packages, each exporting at
    every attempt start and at completion: the final trace files, and the
    metrics files written after, are the same bytes; tokens equal."""
    paths = {}
    outs = {}
    observers = {}
    for pkg, (ov, srv_cls, factory, inj, req_cls, clock) in {
        "ref": (jtiming.override_clock, JLiveServer, lambda: _jengine(tiny),
                jsup.FailureInjector(fail_at_waves=(1,)), JRequest, jtiming.FakeClock(tick=0.0)),
        "port": (timing.override_clock, LiveServer, lambda: _engine(tiny),
                 sup.FailureInjector(fail_at_waves=(1,)), Request, timing.FakeClock(tick=0.0)),
    }.items():
        d = tmp_path / pkg
        d.mkdir()
        obs = observers[pkg] = jobs.Observer() if pkg == "ref" else Observer()
        paths[pkg] = d / "live.json"
        with ov(clock):
            srv = srv_cls(factory, log_path=str(d / "serve.jsonl"), injector=inj, obs=obs,
                          trace_path=str(paths[pkg]))
            outs[pkg] = srv.serve(_reqs(tiny["cfg"], cls=req_cls))
        assert srv.restarts == 1
        assert not [p for p in d.iterdir() if ".tmp." in p.name]
    assert outs["port"] == outs["ref"]
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    _files_equal(observers["ref"], observers["port"], tmp_path)


@pytest.mark.parametrize("decode", DECODES)
def test_event_stream_matches_reference_under_ticking_clock(tiny, decode):
    """Under a clock that moves 1 ms on every read, the same events come in
    the same order with the same name, cat, ph, track and args.  The two
    packages read the clock the same number of times at the same points
    (serve_begin, four reads a wave of the continuous and chunked drivers,
    two a chunk of the loop driver, the ``serve done`` instant), so the
    timestamps are equal too."""
    jo, to = _serve_both(tiny, decode, jtiming.FakeClock(start=1.0, tick=1e-3),
                         timing.FakeClock(start=1.0, tick=1e-3))
    key = lambda e: (e.name, e.cat, e.ph, e.track, e.args)
    jevs, tevs = jo.tracer.events(), to.tracer.events()
    assert [key(e) for e in tevs] == [key(e) for e in jevs]
    assert [(e.ts, e.dur) for e in tevs] == [(e.ts, e.dur) for e in jevs]
    assert to.slo() == jo.slo()
