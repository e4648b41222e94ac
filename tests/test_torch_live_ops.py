"""Port parity: live operations of repro_torch (hot-swap, the durable request
log, supervised kill + replay, poison quarantine, shedding, the chaos sweep)
against the contracts of tests/test_fault_tolerance.py, test_live_ops.py and
test_chaos.py and against the JAX reference's tokens and log bytes (CPU).

One small model serves everything: stablelm-12b smoke cut to 2 layers of
width 32, W1A3 p=2 lut, calibrated (batch-composition invariant, the
bit-exact replay domain), the reference's tree carried into the port and
the port's own prepare of it; the reference is served once undisturbed and
once under a kill, and every port result is held to those."""

import dataclasses
import glob
import os
import random
import sys
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.ft import supervisor as jsup  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve import request_log as jlog  # noqa: E402
from repro.serve.ops import LiveServer as JLiveServer  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.ft import supervisor as sup  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.ops import LiveServer, StagedSwap, SwapController  # noqa: E402
from repro_torch.serve.request_log import RequestLog, replay_state  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

KW = dict(name="live-ops-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
          vocab_size=64, dtype="float32")
BUDGETS = (6, 2, 4, 2)


def _cfgs():
    return (dataclasses.replace(jget_config("stablelm-12b", smoke=True), **KW),
            dataclasses.replace(get_config("stablelm-12b", smoke=True), **KW))


def _ragged(cfg, budgets=BUDGETS, seed=3, cls=Request):
    """Ragged prompts + mixed budgets: a restart re-buckets the survivors
    into other batch compositions than the undisturbed run."""
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(1, cfg.vocab_size, 4 + i % 3).astype(np.int32),
                max_new_tokens=m) for i, m in enumerate(budgets)]


@pytest.fixture(scope="module")
def lut():
    """(cfg, port model, port tree, converted reference tree, reference
    tokens of the undisturbed serve, the raw port tree, calibration)."""
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jp = jm.prepare(jq, calibrate=jnp.asarray(cal))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    tp = tm.prepare(tq, calibrate=cal)
    want = JServeEngine(jm, jp, batch=2, max_seq=32).generate(_ragged(jcfg, cls=JRequest))
    return dict(cfg=tcfg, jm=jm, jp=jp, tm=tm, tp=tp, tq=tq, cal=cal, want=want,
                converted=params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def _factory(lut, tree=None):
    return lambda: ServeEngine(lut["tm"], lut["tp"] if tree is None else tree, batch=2,
                               max_seq=32, device="cpu")


def _live(lut, log_path, **kw):
    return LiveServer(_factory(lut), log_path=str(log_path), **kw)


# --- the durable request log across packages --------------------------------


@pytest.fixture(scope="module")
def reference_killed_log(lut, tmp_path_factory):
    """The reference's LiveServer killed at wave 1, its log rotated every 256
    bytes: (its outputs, the log path)."""
    path = str(tmp_path_factory.mktemp("jlog") / "serve.jsonl")
    srv = JLiveServer(lambda: JServeEngine(lut["jm"], lut["jp"], batch=2, max_seq=32),
                      log_path=path, rotate_bytes=256,
                      injector=jsup.FailureInjector(fail_at_waves=(1,)))
    outs = srv.serve(_ragged(lut["cfg"], cls=JRequest))
    assert srv.restarts == 1 and outs == lut["want"]
    return outs, path


def _log_files(path):
    return [path] + sorted(glob.glob(path + ".*"))


def test_request_log_bytes_equal_reference(lut, reference_killed_log, tmp_path):
    """The same serve (kill at wave 1, rotation at 256 bytes) writes the same
    bytes in both packages, segment for segment: the records carry no
    timestamps."""
    _outs, jpath = reference_killed_log
    path = str(tmp_path / "serve.jsonl")
    srv = _live(lut, path, rotate_bytes=256, injector=sup.FailureInjector(fail_at_waves=(1,)))
    assert srv.serve(_ragged(lut["cfg"])) == lut["want"]
    jfiles, tfiles = _log_files(jpath), _log_files(path)
    assert len(tfiles) == len(jfiles) >= 2               # a rotated segment
    assert [os.path.basename(f)[len("serve.jsonl"):] for f in tfiles] == \
        [os.path.basename(f)[len("serve.jsonl"):] for f in jfiles]
    for a, b in zip(jfiles, tfiles):
        assert open(a, "rb").read() == open(b, "rb").read(), b


def _state(st):
    return (st.requests, st.emitted, st.waves, st.restarts, st.swaps, st.giveups, st.torn_tail,
            st.admitted, st.quarantined, st.shed, st.pending(), st.completed())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_replays_the_others_log(lut, reference_killed_log, tmp_path, writer):
    """Rotated segments and a torn tail: both packages' replay_state fold the
    other's log to the same state; the torn wave is dropped in both."""
    import shutil

    _outs, jpath = reference_killed_log
    path = str(tmp_path / "serve.jsonl")
    if writer == "reference":
        for f in _log_files(jpath):
            shutil.copy(f, str(tmp_path / os.path.basename(f)))
    else:
        _live(lut, path, rotate_bytes=256,
              injector=sup.FailureInjector(fail_at_waves=(1,))).serve(_ragged(lut["cfg"]))
    whole = _state(replay_state(path))
    assert whole == _state(jlog.replay_state(path))
    assert whole[1] == dict(enumerate(lut["want"])) and whole[3] == 1
    with open(path, "a") as f:
        f.write('{"t":"wave","wave":9,"admit":[],"em')            # a crash mid-append
    torn_t, torn_j = replay_state(path), jlog.replay_state(path)
    assert torn_t.torn_tail and _state(torn_t) == _state(torn_j)
    assert _state(torn_t)[:6] == whole[:6]


def test_request_log_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    log = RequestLog(path)
    log.log_request(0, [5, 6, 7], 4)
    log.log_request(1, [9], 2)
    log.log_wave(0, [(0, 0), (1, 1)], [(0, 0, [11, 12]), (1, 1, [13, 14])])
    log.log_wave(1, [], [(0, 0, [15])])
    log.log_restart(1, "InjectedFailure")
    log.log_swap(3)
    log.close()
    st = replay_state(path)
    assert st.requests == {0: ([5, 6, 7], 4), 1: ([9], 2)}
    assert st.emitted == {0: [11, 12, 15], 1: [13, 14]}
    assert (st.waves, st.restarts, st.swaps) == (2, 1, 1)
    assert st.completed() == {1: [13, 14]}
    assert st.pending() == [(0, [5, 6, 7, 11, 12, 15], 1)]
    with open(path, "a") as f:
        f.write('{"t":"wave","wave":2,"em')
    st2 = replay_state(path)
    assert st2.torn_tail and st2.emitted == st.emitted
    lines = open(path).read().splitlines()
    lines[1] = '{"broken'
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="corrupt record"):
        replay_state(path)
    assert replay_state(str(tmp_path / "absent.jsonl")).pending() == []


def test_torn_tail_healed_by_writer(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    log = RequestLog(path)
    log.log_request(0, [1, 2], 4)
    log.close()
    with open(path, "a") as f:
        f.write('{"t":"wave","wa')
    assert replay_state(path).torn_tail
    log = RequestLog(path)
    assert log.healed_torn_tail
    log.log_wave(0, [(0, 0)], [(0, 0, [5, 6])])
    log.close()
    st = replay_state(path)
    assert not st.torn_tail and st.emitted[0] == [5, 6]


# --- kill + replay -----------------------------------------------------------


def test_kill_and_replay_gives_the_reference_tokens(lut, tmp_path):
    """Killed mid-wave (the wave's tokens durable, other slots in flight),
    restarted, replayed: the reference's undisturbed tokens, and the log
    carries every request to completion.  The converted reference tree
    serves the same."""
    srv = _live(lut, tmp_path / "log.jsonl", injector=sup.FailureInjector(fail_at_waves=(1,)))
    assert srv.serve(_ragged(lut["cfg"])) == lut["want"]
    assert srv.restarts == 1 and srv.rebuilds == 2
    st = replay_state(str(tmp_path / "log.jsonl"))
    assert st.restarts == 1 and st.emitted == dict(enumerate(lut["want"]))
    conv = LiveServer(_factory(lut, lut["converted"]), log_path=str(tmp_path / "c.jsonl"),
                      injector=sup.FailureInjector(fail_at_waves=(0, 1)))
    assert conv.serve(_ragged(lut["cfg"])) == lut["want"] and conv.restarts == 2


def test_replay_across_server_instances(lut, tmp_path):
    log = tmp_path / "log.jsonl"
    first = _live(lut, log, injector=sup.FailureInjector(fail_at_waves=(1,)),
                  policy=sup.RestartPolicy(max_restarts=0))
    with pytest.raises(sup.InjectedFailure):
        first.serve(_ragged(lut["cfg"]))
    st = replay_state(str(log))
    assert st.emitted and any(st.remaining(i) > 0 for i in st.requests)
    second = _live(lut, log)
    assert second.serve(_ragged(lut["cfg"])) == lut["want"]
    third = _live(lut, log)                     # everything durable: 0 new waves
    assert third.serve(_ragged(lut["cfg"])) == lut["want"]
    assert third.engine.host_syncs == 0 and third.rebuilds == 1
    with pytest.raises(ValueError, match="does not match the durable log"):
        _live(lut, log).serve(_ragged(lut["cfg"], budgets=(1, 1, 1, 1)))


def test_clean_run_has_no_restarts(lut, tmp_path):
    srv = _live(lut, tmp_path / "log.jsonl")
    assert srv.serve(_ragged(lut["cfg"])) == lut["want"]
    assert srv.restarts == 0 and srv.rebuilds == 1


def test_each_restart_frees_the_previous_engine(lut, tmp_path):
    """When the factory builds attempt n's engine, attempt n-1's engine is
    gone (no garbage collection needed): the server dropped it and the
    restart cleared the failure's frames, which held it and its caches."""
    engines = []

    def factory():
        assert all(r() is None for r in engines), "a previous engine is still alive"
        eng = _factory(lut)()
        engines.append(weakref.ref(eng))
        return eng

    srv = LiveServer(factory, log_path=str(tmp_path / "log.jsonl"),
                     injector=sup.FailureInjector(fail_at_waves=(0, 1)))
    assert srv.serve(_ragged(lut["cfg"])) == lut["want"]
    assert srv.restarts == 2 and len(engines) == 3


def test_served_server_leaves_no_reference_cycle(lut, tmp_path):
    """Once a killed and replayed serve returns and the caller drops the
    server, its last engine is gone without a garbage collection: neither
    the engine's wave hook (it closes over the server) nor the supervisor's
    first failure (its traceback holds the supervisor's frame) keeps a
    cycle that would hold the engine and its tree."""
    import gc

    engines = []

    def factory():
        eng = _factory(lut)()
        engines.append(weakref.ref(eng))
        return eng

    gc.collect()
    gc.disable()
    try:
        srv = LiveServer(factory, log_path=str(tmp_path / "log.jsonl"),
                         injector=sup.FailureInjector(fail_at_waves=(0, 1)))
        assert srv.serve(_ragged(lut["cfg"])) == lut["want"] and srv.restarts == 2
        assert srv.engine is not None and srv.engine.on_wave is None
        del srv
        assert [r() is None for r in engines] == [True] * 3
    finally:
        gc.enable()


# --- hot-swap ------------------------------------------------------------------


class _Watched(ServeEngine):
    """Records the function that assigns ``params`` after construction."""

    def __setattr__(self, name, value):
        if name == "params" and "params" in self.__dict__:
            self.__dict__.setdefault("_param_writers", []).append(sys._getframe(1).f_code.co_name)
        super().__setattr__(name, value)


def _p3_tree(lut):
    """The same weights prepared at p=3 (the int-lut family: identical at every p)."""
    jcfg, _t = _cfgs()
    jm = jbuild(jcfg)
    jq3 = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=3, mode="lut"))
    return lut["tm"].prepare(params_from_numpy(jax.tree.map(np.asarray, jq3), device="cpu"),
                             calibrate=lut["cal"])


def test_mid_stream_swap_is_token_identical_and_only_poll_swap_writes_params(lut):
    """THE swap gate: the same weights re-prepared at p=3, flipped at a wave
    boundary mid-stream: every request to its full budget with the
    reference's tokens, and ``_poll_swap`` the only writer of ``params``."""
    tree_b = _p3_tree(lut)
    eng = _Watched(lut["tm"], lut["tp"], batch=2, max_seq=32, device="cpu")
    seen = []

    def on_wave(rec):
        seen.append(rec.wave)
        if rec.wave == 0:
            eng.request_swap(tree_b)
            assert eng.params is lut["tp"]          # pending, not installed mid-wave

    eng.on_wave = on_wave
    got = eng.generate(_ragged(lut["cfg"]))
    assert got == lut["want"] and [len(o) for o in got] == list(BUDGETS)
    assert eng.swaps == 1 and eng.last_swap_wave == 1 and len(seen) >= 3
    assert eng.params is tree_b
    assert eng._param_writers == ["_poll_swap"]


def test_swap_lands_at_a_chunk_boundary_in_the_chunked_driver(lut, monkeypatch):
    tree_b = _p3_tree(lut)
    eng = ServeEngine(lut["tm"], lut["tp"], batch=2, max_seq=32, decode="chunked", device="cpu")
    run = eng._generate_batch_chunked

    def first_chunk_requests_swap(chunk, start=0):
        out = run(chunk, start)
        if eng.swaps == 0 and eng._swap_pending is None:
            eng.request_swap(tree_b)
        return out

    monkeypatch.setattr(eng, "_generate_batch_chunked", first_chunk_requests_swap)
    assert eng.generate(_ragged(lut["cfg"])) == lut["want"]
    assert eng.swaps == 1 and eng.last_swap_wave == 1 and eng.params is tree_b


def test_swap_while_idle_applies_immediately(lut):
    eng = ServeEngine(lut["tm"], lut["tp"], batch=2, max_seq=32, device="cpu")
    applied = []
    eng.request_swap(lut["tm"].prepare(lut["tq"], calibrate=lut["cal"]),
                     on_applied=lambda: applied.append(1))
    assert eng.swaps == 1 and applied == [1] and eng.last_swap_wave is None


def test_incompatible_swaps_refused_and_engine_serves_on(lut):
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    wide = params_from_numpy(jax.tree.map(np.asarray, jm.quantize(
        jm.init(jax.random.PRNGKey(0)), JSpec(bw=2, ba=3, p=2, mode="lut"))), device="cpu")
    eng = ServeEngine(lut["tm"], lut["tp"], batch=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="bw"):                    # bitwidth drift
        eng.request_swap(lut["tm"].prepare(wide, calibrate=lut["cal"]))
    with pytest.raises(ValueError, match="calibration"):           # calibration drift
        eng.request_swap(lut["tm"].prepare(lut["tq"]))
    assert eng.params is lut["tp"] and eng.swaps == 0
    assert eng.generate(_ragged(lut["cfg"])) == lut["want"]
    dense = ServeEngine(lut["tm"], lut["tm"].init(seed=0, device="cpu"), batch=2, max_seq=32,
                        device="cpu")
    other = build_model(dataclasses.replace(tcfg, d_ff=48))
    with pytest.raises(ValueError, match="dense"):
        dense.request_swap(other.init(seed=0, device="cpu"))


def test_swap_controller_stages_in_background_and_flips(lut):
    eng = ServeEngine(lut["tm"], lut["tp"], batch=2, max_seq=32, device="cpu")
    ctl = SwapController(eng)
    staged = ctl.stage(qparams=lut["tq"], prepare_kw={"calibrate": lut["cal"]})
    report = ctl.flip(staged)
    assert report.swaps == 1 and report.stage_seconds >= 0.0 and staged.ready is None
    assert eng.generate(_ragged(lut["cfg"])) == lut["want"]
    with pytest.raises(ValueError, match="exactly one"):
        ctl.stage(params=eng.params, qparams=lut["tq"])
    before = eng.params
    bad = ctl.stage(qparams=lut["tq"], prepare_kw={"bogus_kw": 1})
    with pytest.raises(RuntimeError, match="stage failed"):
        ctl.flip(bad)
    assert eng.params is before
    garbage = ctl.stage(params={"not": "a model tree"})
    with pytest.raises(ValueError, match="incompatible hot-swap"):
        ctl.flip(garbage)
    assert eng.params is before


def test_swap_status_and_dead_stage_surfaced(lut):
    engine = ServeEngine(lut["tm"], lut["tp"], batch=2, max_seq=32, device="cpu")
    ctrl = SwapController(engine)
    st = ctrl.status()
    assert not st["staging"] and not st["flip_pending"] and st["swaps"] == 0

    def boom():
        raise RuntimeError("oom while preparing")

    ctrl.last_staged = staged = StagedSwap(boom)
    with pytest.raises(RuntimeError, match="stage failed"):
        ctrl.flip(staged, timeout=30.0)
    assert "oom" in ctrl.status()["stage_error"]
    ctrl.last_staged = dead = StagedSwap(lambda: None)
    with pytest.raises(RuntimeError, match="died without producing"):
        ctrl.flip(dead, timeout=30.0)
    assert ctrl.status()["stage_dead"]
    rep = ctrl.flip(ctrl.stage(params=lut["tp"]), timeout=60.0)
    assert rep.swaps == 1 and ctrl.status()["staged_ready"]


# --- request fault domains ---------------------------------------------------------


@pytest.mark.parametrize("poison", [0, 2])
def test_poison_request_quarantined_survivors_identical(lut, tmp_path, poison):
    srv = _live(lut, tmp_path / f"poison{poison}.jsonl", policy=sup.RestartPolicy(max_restarts=8),
                injector=sup.FailureInjector(poison_requests=(poison,)))
    outs = srv.serve(_ragged(lut["cfg"]))
    assert set(srv.quarantined) == {poison}
    assert "poison" in srv.quarantined[poison] or "retry budget" in srv.quarantined[poison]
    assert srv.restarts <= 4
    assert all(outs[i] == lut["want"][i] for i in range(len(BUDGETS)) if i != poison)
    assert poison in replay_state(str(tmp_path / f"poison{poison}.jsonl")).quarantined


def test_poison_retry_budget_quarantines_without_attribution(lut, tmp_path):
    reqs = _ragged(lut["cfg"])
    reqs[2] = dataclasses.replace(reqs[2], max_retries=1)
    srv = _live(lut, tmp_path / "budget.jsonl", policy=sup.RestartPolicy(max_restarts=8),
                injector=sup.FailureInjector(poison_requests=(2,)))
    outs = srv.serve(reqs)
    assert set(srv.quarantined) == {2} and "retry budget" in srv.quarantined[2]
    assert all(outs[i] == lut["want"][i] for i in range(len(reqs)) if i != 2)


def test_bounded_queue_backpressure(lut, tmp_path):
    reqs = _ragged(lut["cfg"])
    srv = _live(lut, tmp_path / "q.jsonl", queue_limit=2)
    assert srv.submit(reqs[0]) and srv.submit(reqs[1])
    assert not srv.submit(reqs[2])          # backpressure, nothing buffered
    srv.drain()
    assert srv.submit(reqs[2])
    assert srv.drain() == lut["want"][:3]   # earlier results carried by the log


def test_deadline_shedding_reports_partial_prefix(lut, tmp_path):
    reqs = _ragged(lut["cfg"])
    reqs[0] = dataclasses.replace(reqs[0], deadline_s=50.0)
    t = {"v": 0.0}
    srv = _live(lut, tmp_path / "shed.jsonl", policy=sup.RestartPolicy(max_restarts=8),
                injector=sup.FailureInjector(fail_at_waves=(0,)),
                on_restart=lambda a, e: t.__setitem__("v", t["v"] + 100.0),
                clock=lambda: t["v"])
    outs = srv.serve(reqs)
    assert set(srv.shed) == {0} and "deadline" in srv.shed[0]
    assert 0 < len(outs[0]) < reqs[0].max_new_tokens
    assert outs[0] == lut["want"][0][: len(outs[0])]
    assert all(outs[i] == lut["want"][i] for i in range(len(reqs)) if i != 0)


def test_request_log_rotation_and_compaction(lut, tmp_path):
    path = str(tmp_path / "rot.jsonl")
    srv = _live(lut, path, rotate_bytes=256, injector=sup.FailureInjector(fail_at_waves=(1,)))
    assert srv.serve(_ragged(lut["cfg"])) == lut["want"]
    assert glob.glob(path + ".*")
    st = replay_state(path)
    log = RequestLog(path)
    stats = log.compact()
    log.close()
    assert stats["after_bytes"] < stats["before_bytes"] and not glob.glob(path + ".*")
    st2 = replay_state(path)
    assert {i: st2.emitted[i] for i in st2.requests} == dict(enumerate(lut["want"]))
    assert st2.restarts == st.restarts == 1
    assert _live(lut, path).serve(_ragged(lut["cfg"])) == lut["want"]


# --- the chaos sweep -------------------------------------------------------------------


def test_chaos_sweep_all_seams_green(lut, tmp_path):
    """One seeded kill per seam: every fault fires, every request completes
    to budget with the reference's tokens, the torn checkpoint falls back to
    the cold tree (counted), and restarts happened."""
    from repro_torch.ft.chaos import SEAMS, chaos_sweep

    rep = chaos_sweep(model=lut["tm"], prepared=lut["tp"], requests=_ragged(lut["cfg"]),
                      workdir=str(tmp_path), points_per_seam=1, seed=0, device="cpu")
    assert rep["points"] == len(SEAMS) and rep["seams"] == list(SEAMS)
    assert rep["dropped"] == 0 and rep["token_mismatches"] == 0 and rep["restarts"] > 0
    assert rep["cold_fallbacks"] >= 1
    for r in rep["results"]:
        assert r["fired"], r
        assert r["dropped"] == 0 and r["token_mismatches"] == 0, r
    assert not glob.glob(str(tmp_path / "*_ckpt"))          # one checkpoint at a time, removed
    a = chaos_sweep(model=lut["tm"], prepared=lut["tp"], requests=_ragged(lut["cfg"]),
                    workdir=str(tmp_path / "again"), points_per_seam=1, seed=0, device="cpu",
                    seams=("mid_wave", "torn_tail"))
    assert a["results"] == [r for r in rep["results"] if r["seam"] in ("mid_wave", "torn_tail")]


# --- supervision (mirrors tests/test_fault_tolerance.py's generic part) --------------


def test_non_retryable_exception_propagates_immediately():
    calls = []

    def body(attempt):
        calls.append(attempt)
        raise ValueError("shape error: restarting would loop forever")

    with pytest.raises(ValueError, match="shape error"):
        sup.supervise(body, policy=sup.RestartPolicy(max_restarts=8))
    assert calls == [0]


def test_exhaustion_reraises_the_original_failure():
    def body(attempt):
        raise sup.InjectedFailure(f"crash #{attempt}")

    with pytest.raises(sup.InjectedFailure, match="crash #0") as ei:
        sup.supervise(body, policy=sup.RestartPolicy(max_restarts=2))
    assert isinstance(ei.value.__cause__, sup.InjectedFailure)
    assert "crash #2" in str(ei.value.__cause__)


def test_supervise_recovers_and_reports_restart_count():
    seen = []

    def body(attempt):
        if attempt < 2:
            raise sup.InjectedFailure("transient")
        return "done"

    result, restarts = sup.supervise(body, policy=sup.RestartPolicy(max_restarts=5),
                                     on_restart=lambda n, e: seen.append((n, type(e).__name__)))
    assert (result, restarts) == ("done", 2)
    assert seen == [(1, "InjectedFailure"), (2, "InjectedFailure")]


def test_backoff_is_deterministic_exponential_capped_and_equals_reference():
    pol = sup.RestartPolicy(backoff_s=1.0, backoff_factor=2.0, max_backoff_s=5.0,
                            jitter_frac=0.1, seed=7)
    jpol = jsup.RestartPolicy(backoff_s=1.0, backoff_factor=2.0, max_backoff_s=5.0,
                              jitter_frac=0.1, seed=7)
    a = [pol.delay_s(i, random.Random(pol.seed)) for i in (1, 2, 3, 4, 5)]
    assert a == [jpol.delay_s(i, random.Random(7)) for i in (1, 2, 3, 4, 5)]
    for base, d in zip((1.0, 2.0, 4.0, 5.0, 5.0), a):
        assert base <= d <= base * 1.1
    assert sup.RestartPolicy().delay_s(3, random.Random(0)) == 0.0


def test_supervise_sleeps_the_policy_backoff():
    slept = []

    def body(attempt):
        if attempt < 2:
            raise sup.InjectedFailure("x")
        return attempt

    pol = sup.RestartPolicy(backoff_s=0.25, backoff_factor=2.0, jitter_frac=0.0, max_restarts=4)
    _, restarts = sup.supervise(body, policy=pol, sleep=slept.append)
    assert restarts == 2 and slept == [0.25, 0.5]


def test_failure_injector_fires_once_per_wave():
    inj = sup.FailureInjector(fail_at_waves=(2,))
    inj.maybe_fail_wave(0)
    inj.maybe_fail_wave(1)
    with pytest.raises(sup.InjectedFailure, match="wave 2"):
        inj.maybe_fail_wave(2)
    inj.maybe_fail_wave(2)
    inj2 = sup.FailureInjector(fail_at_steps=(1,), fail_at_waves=(1,))
    with pytest.raises(sup.InjectedFailure):
        inj2.maybe_fail(1)
    with pytest.raises(sup.InjectedFailure):
        inj2.maybe_fail_wave(1)
    with pytest.raises(sup.InjectedFailure, match="poison request 3"):
        sup.FailureInjector(poison_requests=(3,)).maybe_fail_requests([1, 3])


def test_deadline_gives_up_before_restart_budget():
    t = {"now": 0.0}
    calls, giveups = [], []

    def body(attempt):
        calls.append(attempt)
        t["now"] += 10.0
        raise sup.InjectedFailure(f"crash #{attempt}")

    with pytest.raises(sup.InjectedFailure, match="crash #0"):
        sup.supervise(body, policy=sup.RestartPolicy(max_restarts=100, deadline_s=25.0),
                      on_giveup=giveups.append, clock=lambda: t["now"])
    assert calls == [0, 1, 2]
    assert len(giveups) == 1 and "crash #0" in str(giveups[0])


def test_on_giveup_fires_on_exhaustion_only_for_retryable():
    giveups = []

    def crash(attempt):
        raise sup.InjectedFailure(f"crash #{attempt}")

    with pytest.raises(sup.InjectedFailure, match="crash #0"):
        sup.supervise(crash, policy=sup.RestartPolicy(max_restarts=2), on_giveup=giveups.append)
    assert [str(g) for g in giveups] == ["crash #0"]

    def shape(attempt):
        raise ValueError("shape error")

    with pytest.raises(ValueError, match="shape error"):
        sup.supervise(shape, policy=sup.RestartPolicy(max_restarts=8), on_giveup=giveups.append)
    assert len(giveups) == 1


# --- launch/serve.py end to end ----------------------------------------------------------


def test_launch_serve_prepared_checkpoint_and_request_log(tmp_path, capsys):
    """``--prepared-ckpt`` twice: the second run restores (no quantize, no
    prepare) and gives the same tokens; ``--request-log`` twice: the second
    run replays every token from the log and serves 0 new waves."""
    from repro_torch.launch import serve as launch_serve

    args = ["--smoke", "--mode", "lut", "--calibrate", "32", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--prepared-ckpt", str(tmp_path / "ckpt")]
    first = launch_serve.main(args)
    out1 = capsys.readouterr().out
    assert "saved prepared checkpoint" in out1 and "restored" not in out1
    again = launch_serve.main(args)
    out2 = capsys.readouterr().out
    assert "restored prepared checkpoint step 0" in out2 and "quantized" not in out2
    assert again == first and [len(o) for o in first] == [4, 4, 4]
    logged = args + ["--request-log", str(tmp_path / "serve.jsonl")]
    assert launch_serve.main(logged) == first
    out3 = capsys.readouterr().out
    assert "live serve: 0 restarts" in out3 and ", 0 host syncs" not in out3
    assert launch_serve.main(logged) == first
    assert ", 0 host syncs" in capsys.readouterr().out       # 0 new waves
    with pytest.raises(SystemExit):
        launch_serve.build_args(["--request-log", "x.jsonl", "--decode", "loop"])
