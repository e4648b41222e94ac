"""Port parity: repro_torch's ServeEngine against itself (scan == loop) and
against the JAX reference's ServeEngine, on stablelm-12b smoke (f32, W4A4,
mode="pallas", prepared) with weights converted from the reference (CPU)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine, WaveRecord, bucket_to  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.prepare(jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=4, ba=4, mode="pallas")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


def _engine(tm, tp, decode, **kw):
    return ServeEngine(tm, tp, batch=2, max_seq=32, decode=decode, device="cpu", **kw)


def _ragged(cfg, seed=0, lens=(3, 9, 5, 12, 6), budgets=(4, 6, 3, 5, 2)):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(lens, budgets)]


def test_scan_matches_loop_token_for_token(models):
    cfg, _jm, _jp, tm, tp = models
    rng = np.random.default_rng(0)
    # prompts at the bucket boundary -> identical left-padding in both drivers
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=m) for m in (4, 6, 3)]
    scan, loop = _engine(tm, tp, "scan"), _engine(tm, tp, "loop")
    o_scan, o_loop = scan.generate(reqs), loop.generate(reqs)
    assert o_scan == o_loop
    assert [len(o) for o in o_scan] == [4, 6, 3]
    assert loop.host_syncs == 6 + 3                 # one per decoded token


def test_ragged_scan_matches_loop(models):
    """Pad-masked bucketing makes ragged prompts output-invariant too."""
    cfg, _jm, _jp, tm, tp = models
    reqs = _ragged(cfg)
    assert _engine(tm, tp, "scan").generate(reqs) == _engine(tm, tp, "loop").generate(reqs)


def test_scan_tokens_and_admissions_match_reference(models):
    cfg, jm, jp, tm, tp = models
    reqs = _ragged(cfg, seed=3)
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode="scan")
    teng = _engine(tm, tp, "scan")
    want = jeng.generate(jreqs)
    got = teng.generate(reqs)
    assert got == want
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts


def test_one_sync_per_wave_and_exact_budgets(models):
    cfg, _jm, _jp, tm, tp = models
    eng = _engine(tm, tp, "scan")
    waves: list[WaveRecord] = []
    eng.on_wave = waves.append
    reqs = _ragged(cfg, seed=1, budgets=(7, 2, 5, 3, 4))
    outs = eng.generate(reqs)
    assert [len(o) for o in outs] == [7, 2, 5, 3, 4]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert eng.host_syncs == len(waves)
    assert [w.wave for w in waves] == list(range(len(waves)))
    assert sorted(i for w in waves for i in w.finished) == list(range(len(reqs)))
    assert [a for w in waves for a in w.admitted] == eng.admissions
    assert sum(len(t) for w in waves for _i, _s, t in w.emitted) == sum(len(o) for o in outs)
    eng.host_syncs = 0
    eng.generate(_ragged(cfg, seed=1, budgets=(14, 14, 14, 14, 14)))
    assert eng.host_syncs <= len(reqs) + 1          # O(1) per wave, not per token


def test_bucket_and_fit_rules():
    assert bucket_to(5, 8) == 8 and bucket_to(9, 8) == 16 and bucket_to(9, 1) == 9
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), dtype="float32")
    tm = build_model(cfg)
    tp = tm.init(0, device="cpu")
    eng = ServeEngine(tm, tp, batch=2, max_seq=20, device="cpu")
    # the bucket shrinks near max_seq: 9 -> 16 would not leave room for 8 tokens
    assert eng._wave_bucket([Request(np.zeros(9, np.int32), 8)]) == 12
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.generate([Request(np.zeros(15, np.int32), 8)])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([Request(np.zeros(0, np.int32), 2)])
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(tm, tp, batch=2, max_seq=20, device="meta")


# ---------------------------------------------------------------------------
# A calibrated int-LUT model: the reference's live-ops config (2 layers,
# W1A3 p=2, mode="lut"), converted, calibrated by the port itself, in
# float32 here and in its own bfloat16 below.
# ---------------------------------------------------------------------------

TOL_LOGIT = 1e-5      # f32: relative to max |logit|; the int32 sums are exact


def _lut_models(dtype):
    kw = dict(name="live-ops-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              d_ff=64, vocab_size=64, dtype=dtype)
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jp = jm.prepare(jq, calibrate=jax.numpy.asarray(cal))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    tp = tm.prepare(tq, calibrate=cal)
    return tcfg, jm, jp, tm, tp, cal


@pytest.fixture(scope="module")
def lut_models():
    return _lut_models("float32")


@pytest.fixture(scope="module")
def converted_lut_tree(lut_models):
    """The reference's calibrated, prepared tree carried across as it is."""
    _cfg, _jm, jp, _tm, _tp, _cal = lut_models
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_calibrated_lut_scales_and_products_match_reference(lut_models, converted_lut_tree):
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    _cfg, _jm, jp, _tm, tp, _cal = lut_models
    jl, tl = dict(jitems(jp)), dict(titems(tp))
    cl = dict(titems(converted_lut_tree))
    assert sorted(jl) == sorted(tl) == sorted(cl) and len(tl) == 7
    for path, lj in jl.items():
        lt, lc = tl[path], cl[path]
        # the converted tree arrives with the reference's dtypes and stacked shapes
        assert lc.wpk.dtype == torch.int32 and lc.wpk.shape == np.asarray(lj.wpk).shape
        assert lc.ascale.dtype == torch.float32 and lc.ascale.shape == (2,)
        assert lc.onehot is None and (lc.wcanon is None) == (lj.wcanon is None)
        if lc.wcanon is not None:
            assert lc.wcanon.dtype == torch.int32 and torch.equal(lc.wcanon, lt.wcanon)
        assert torch.equal(lc.wpk, lt.wpk)
        want = np.asarray(lj.ascale)
        assert lt.ascale.shape == want.shape == (2,), path          # one per stacked unit
        # f32 rounding: the layernorm's f32 mean is reduced in another order
        # by XLA and by torch, so the amax can differ in its last bit (in
        # bf16 the scales are equal bit for bit, see the bf16 test below)
        np.testing.assert_allclose(lt.ascale.numpy(), want, rtol=2**-21, atol=0)
        assert lt.p == lj.p and lt.wpk.dtype == torch.int32
        assert np.array_equal(lt.wpk.numpy(), np.asarray(lj.wpk))
        assert (lt.wcanon is None) == (lj.wcanon is None) and lt.onehot is None
        if lt.wcanon is not None:
            assert np.array_equal(lt.wcanon.numpy(), np.asarray(lj.wcanon))


def test_calibrated_lut_logits_match_reference(lut_models):
    cfg, jm, jp, tm, tp, cal = lut_models
    jnp = jax.numpy
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    lj, cj = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 16, jnp.float32))
    lt, ct = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(2, 16, torch.float32,
                                                                 device="cpu"))
    scale = float(np.abs(np.asarray(lj)).max())
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj), rtol=0, atol=TOL_LOGIT * scale)
    nxt = np.asarray(lj).argmax(-1).astype(np.int32)               # [2, 1]
    dj, _ = jm.decode_step(jp, jnp.asarray(nxt), cj, jnp.int32(7))
    dt, _ = tm.decode_step(tp, torch.from_numpy(nxt), ct, 7)
    np.testing.assert_allclose(dt.float().numpy(), np.asarray(dj), rtol=0, atol=TOL_LOGIT * scale)
    assert torch.equal(lt.argmax(-1), torch.from_numpy(nxt).long())
    assert torch.equal(dt.argmax(-1), torch.from_numpy(np.asarray(dj).argmax(-1)))


def test_calibrated_lut_serve_matches_reference(lut_models, converted_lut_tree):
    cfg, jm, jp, tm, tp, _cal = lut_models
    reqs = _ragged(cfg, seed=5, lens=(6, 6, 6, 6), budgets=(6, 2, 4, 2))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode="scan")
    want = jeng.generate(jreqs)
    scan, loop = _engine(tm, tp, "scan"), _engine(tm, tp, "loop")
    got = scan.generate(reqs)
    assert got == want
    assert scan.admissions == jeng.admissions and scan.host_syncs == jeng.host_syncs
    assert loop.generate(reqs) == got
    assert _engine(tm, converted_lut_tree, "scan").generate(reqs) == want


def test_bf16_calibrated_lut_scales_and_tokens_match_reference():
    """The reference's live-ops model as it runs, in bfloat16: the port's 14
    frozen scales (7 projections x 2 units) and its served tokens equal the
    reference's bit for bit.  This needs the activation quantizer's scale as
    XLA computes it under jit (amax * f32(1/gmax)), silu op by op in bf16,
    and the FFN norm read from the unrounded f32 residual sum (XLA's excess
    precision inside the fused scan body)."""
    from repro.tune.plan import quantized_leaf_items as jitems
    from repro_torch.tune.plan import quantized_leaf_items as titems

    cfg, jm, jp, tm, tp, _cal = _lut_models("bfloat16")
    jl, tl = dict(jitems(jp)), dict(titems(tp))
    assert sorted(jl) == sorted(tl) and len(tl) == 7
    for path, lj in jl.items():
        np.testing.assert_array_equal(tl[path].ascale.numpy(), np.asarray(lj.ascale), path)
    reqs = _ragged(cfg, seed=5, lens=(6, 6, 6, 6), budgets=(6, 2, 4, 2))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    want = JServeEngine(jm, jp, batch=2, max_seq=32, decode="scan").generate(jreqs)
    assert _engine(tm, tp, "scan").generate(reqs) == want


# ---------------------------------------------------------------------------
# decode="chunked": the fixed-chunk driver, one host sync per chunk
# ---------------------------------------------------------------------------


def test_chunked_matches_scan_and_loop(models):
    cfg, _jm, _jp, tm, tp = models
    reqs = _ragged(cfg, seed=2)
    chunked = _engine(tm, tp, "chunked")
    got = chunked.generate(reqs)
    assert got == _engine(tm, tp, "scan").generate(reqs) == _engine(tm, tp, "loop").generate(reqs)
    assert [len(o) for o in got] == [r.max_new_tokens for r in reqs]
    assert chunked.host_syncs == -(-len(reqs) // chunked.batch)      # one per chunk


def test_chunked_tokens_syncs_and_buckets_match_reference(models):
    cfg, jm, jp, tm, tp = models
    reqs = _ragged(cfg, seed=6, lens=(3, 9, 5, 12, 6, 17), budgets=(4, 6, 3, 5, 2, 7))
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode="chunked")
    teng = _engine(tm, tp, "chunked")
    assert teng.generate(reqs) == jeng.generate(jreqs)
    assert teng.host_syncs == jeng.host_syncs == 3
    assert teng.bucket_counts == jeng.bucket_counts
    # a decode-length bucket that would overflow max_seq falls back to the
    # exact budget, in both packages
    tight = [Request(prompt=np.arange(1, 20, dtype=np.int32), max_new_tokens=9)]
    jtight = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in tight]
    assert teng.generate(tight) == jeng.generate(jtight)
    assert teng.bucket_counts == jeng.bucket_counts


def test_chunked_rejects_infeasible_chunk_pair_continuous_serves_it(models):
    """A long-prompt + long-budget pair that cannot share one chunk: the
    chunked driver raises; the continuous scheduler admits them into
    separate waves and serves both."""
    _cfg, _jm, _jp, tm, tp = models
    reqs = [
        Request(prompt=np.ones(24, np.int32), max_new_tokens=2),
        Request(prompt=np.ones(2, np.int32), max_new_tokens=24),
    ]
    with pytest.raises(ValueError, match="exceeds max_seq"):
        _engine(tm, tp, "chunked").generate(reqs)
    assert [len(o) for o in _engine(tm, tp, "scan").generate(reqs)] == [2, 24]
    assert _engine(tm, tp, "chunked").generate(
        [Request(prompt=np.zeros(4, np.int32), max_new_tokens=0)]) == [[]]


# ---------------------------------------------------------------------------
# ServeEngine(plan=): the autotuned int-LUT model (the reference's
# tests/test_tune.py model: 2 layers, W1A3 p=2 lut, a plan that re-tunes p)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planned_models():
    from repro.tune import planner as jplanner
    from repro_torch.tune import planner as tplanner

    kw = dict(name="tune-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
              vocab_size=64)
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    pkw = dict(lut_budget_bytes=1 << 22, n_hint=2, measure=False, p_cap=4)
    jplan, tplan = jplanner.plan_model(jq, **pkw), tplanner.plan_model(tq, **pkw)
    return tcfg, jm, jq, jplan, tm, tq, tplan


def test_planned_engine_serves_fixed_spec_and_reference_tokens(planned_models):
    """Plans change engines, never tokens: ServeEngine(plan=) equals the
    fixed-spec prepared model, and the reference's planned engine on the
    same tree, in scan and chunked alike (the scales are dynamic here, so
    each driver's batches set them: chunked is held to chunked)."""
    cfg, jm, jq, jplan, tm, tq, tplan = planned_models
    assert tplan.to_json() == jplan.to_json()
    assert any(lp.p != 2 for lp in tplan.layers.values())      # the plan re-tunes
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 64, n).astype(np.int32), max_new_tokens=4)
            for n in (3, 5, 4)]
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    fixed = ServeEngine(tm, tm.prepare(tq), batch=2, max_seq=32, device="cpu")
    planned = ServeEngine(tm, tq, batch=2, max_seq=32, plan=tplan, device="cpu")
    assert planned.plan is tplan
    want = JServeEngine(jm, jq, batch=2, max_seq=32, plan=jplan).generate(jreqs)
    assert planned.generate(reqs) == fixed.generate(reqs) == want
    jchunked = JServeEngine(jm, jq, batch=2, max_seq=32, plan=jplan, decode="chunked")
    chunked = ServeEngine(tm, tq, batch=2, max_seq=32, plan=tplan, decode="chunked",
                          device="cpu")
    fixed_chunked = ServeEngine(tm, tm.prepare(tq), batch=2, max_seq=32, decode="chunked",
                                device="cpu")
    assert chunked.generate(reqs) == jchunked.generate(jreqs) == fixed_chunked.generate(reqs)


def test_model_prepare_with_plan_and_calibration(planned_models):
    """Model.prepare(plan=, calibrate=): calibration runs first on the raw
    tree, then the plan applies; the plan's fingerprint ignores the frozen
    scales, so one plan serves the calibrated tree and the raw one alike."""
    from repro_torch.tune.plan import calibration_digests, quantized_leaf_items
    from repro_torch.tune.planner import verify_capacity

    cfg, _jm, _jq, _jplan, tm, tq, tplan = planned_models
    cal = np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    both = tm.prepare(tq, plan=tplan, calibrate=cal)
    verify_capacity(both, tplan)
    calibrated = tm.prepare(tq, calibrate=cal)
    assert calibration_digests(both) == calibration_digests(calibrated)
    assert all(d is not None for d in calibration_digests(both).values())
    for path, leaf in quantized_leaf_items(both):
        assert leaf.spec.p == tplan.layers[path].p
    reqs = _ragged(cfg, seed=4, lens=(6, 6, 6), budgets=(3, 5, 2))
    assert ServeEngine(tm, both, batch=2, max_seq=32, device="cpu").generate(reqs) == \
        ServeEngine(tm, calibrated, batch=2, max_seq=32, device="cpu").generate(reqs)
    with pytest.raises(ValueError, match="raw quantized tree"):
        ServeEngine(tm, calibrated, batch=2, max_seq=32, plan=tplan, device="cpu")


# ---------------------------------------------------------------------------
# gemma2-2b smoke (2 x "LG", window 8, softcap 50; f32, W4A4 pallas prepared)
# through the ring-window cache: at max_seq <= window every local cache
# takes the ring branch without a flag; under the serve profile at max_seq 32
# > window the local layers hold rings of 8 slots (prompts of up to 12 tokens
# and decode wrap them) and the global layers int8 caches
# ---------------------------------------------------------------------------


def _pallas_pair(jcfg, tcfg):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.prepare(jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=4, ba=4, mode="pallas")))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _gemma_cfgs(profile, **kw):
    from repro.models.profiles import apply_perf_profile as japply
    from repro_torch.models.profiles import apply_perf_profile as tapply

    jcfg = dataclasses.replace(jget_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    return japply(jcfg, profile, tp=2), tapply(tcfg, profile, tp=2)


@pytest.fixture(scope="module")
def gemma_ring():
    """window 64 > max_seq 32: the flag-free ring branch (no wrap)."""
    return _pallas_pair(*_gemma_cfgs("baseline", window=64))


@pytest.fixture(scope="module")
def gemma_profile():
    return _pallas_pair(*_gemma_cfgs("serve"))


def _serve_pair(jm, jp, tm, tp, reqs, decode):
    jreqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode=decode)
    teng = _engine(tm, tp, decode)
    want = jeng.generate(jreqs)
    got = teng.generate(reqs)
    return jeng, teng, want, got


@pytest.mark.parametrize("which", ["ring", "profile"])
def test_gemma2_ring_serve_matches_reference(which, gemma_ring, gemma_profile):
    jm, jp, tm, tp = gemma_ring if which == "ring" else gemma_profile
    caches = tm.init_cache(2, 32, torch.float32, device="cpu")[0]
    if which == "ring":
        assert caches["s0_L"]["k"].shape[2] == 32 <= tm.cfg.window
    else:
        assert caches["s0_L"]["k"].shape[2] == tm.cfg.window == 8
        assert caches["s1_G"]["k"].dtype == torch.int8
    reqs = _ragged(tm.cfg, seed=7)
    jeng, teng, want, got = _serve_pair(jm, jp, tm, tp, reqs, "scan")
    assert got == want
    assert [len(o) for o in got] == [r.max_new_tokens for r in reqs]
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts


def test_gemma2_profile_serves_under_every_decode_mode(gemma_profile):
    """decode="scan", "chunked" and "loop" serve the ring and int8 caches:
    scan == loop token for token, chunked == the reference's chunked."""
    jm, jp, tm, tp = gemma_profile
    reqs = _ragged(tm.cfg, seed=8)
    scan = _engine(tm, tp, "scan").generate(reqs)
    assert _engine(tm, tp, "loop").generate(reqs) == scan
    jeng, teng, want, got = _serve_pair(jm, jp, tm, tp, reqs, "chunked")
    assert got == want
    assert teng.host_syncs == jeng.host_syncs == -(-len(reqs) // 2)


def test_stablelm_serve_profile_matches_reference():
    """stablelm-12b smoke under the profile: int8 "D" caches, bf16 attend."""
    from repro.models.profiles import apply_perf_profile as japply
    from repro_torch.models.profiles import apply_perf_profile as tapply

    jcfg = japply(dataclasses.replace(jget_config("stablelm-12b", smoke=True), dtype="float32"),
                  "serve")
    tcfg = tapply(dataclasses.replace(get_config("stablelm-12b", smoke=True), dtype="float32"),
                  "serve")
    assert tcfg.kv_cache_int8 and tcfg.attend_bf16 and not tcfg.ring_window_cache
    jm, jp, tm, tp = _pallas_pair(jcfg, tcfg)
    reqs = _ragged(tm.cfg, seed=9)
    jeng, teng, want, got = _serve_pair(jm, jp, tm, tp, reqs, "scan")
    assert got == want
    assert teng.admissions == jeng.admissions and teng.host_syncs == jeng.host_syncs


def test_launch_serve_profile_flag(capsys):
    """``python -m repro_torch.launch.serve --profile serve`` applies the
    profile before building the model and says so."""
    from repro_torch.launch import serve as launch_serve

    outs = launch_serve.main(["--arch", "gemma2-2b", "--smoke", "--mode", "pallas",
                              "--profile", "serve", "--device", "cpu", "--requests", "2",
                              "--max-new", "4"])
    printed = capsys.readouterr().out
    assert "perf profile: serve\n" in printed
    assert [len(o) for o in outs] == [4, 4]
    launch_serve.main(["--arch", "gemma2-2b", "--smoke", "--mode", "pallas", "--device", "cpu",
                       "--requests", "1", "--max-new", "2"])
    assert "perf profile" not in capsys.readouterr().out
