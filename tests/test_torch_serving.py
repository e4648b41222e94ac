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
