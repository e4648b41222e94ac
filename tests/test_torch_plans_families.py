"""Port parity: plans, prepared checkpoints and live ops over the MoE + MLA,
recurrent and encoder-decoder trees (deepseek-v2-lite-16b, zamba2-7b,
rwkv6-3b, whisper-large-v3) against the JAX reference (CPU).

Each family is one module-scoped fixture: the f32 smoke config, W1A3
``lut``, the reference launcher's tree (``Model.quantize(Model.init(
PRNGKey(0)))``) carried into the port with its walk order kept, and the
analytic plans of both packages at two budgets.  The int-lut family gives
one set of tokens at every p, so a planned serve is held to the reference's
planned serve of the same tree, driver for driver; deepseek's to the
reference's raw tree, which is the only one the reference can serve (its
``_dense_weight`` does not decode a prepared MLA leaf: ROADMAP Queue 3,
reference defect 3).  The port's own calibrated tree is held to itself: a
plan and a hot-swap between plans change no token.

Kill + replay: a restart re-prefills ``prompt + emitted`` of every request in
flight.  Both packages are held to each other under the same injected
failure on every family.  The clean serve's tokens come back where the
replay computes each row as the clean serve did: on whisper's decoder (full
caches, no MoE) for any requests; on the recurrent trees, whose left pads
pass through the state (``src/repro/serve/serving.py:37-38``), where every
wave and every replay prefills rows of one length (no pad); on deepseek,
whose MoE capacity follows each call's token count, on a dropless copy
(``capacity_factor`` 64) of such waves.
"""

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.ft import supervisor as jsup  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve.ops import LiveServer as JLiveServer  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.tune import planner as jplanner  # noqa: E402
from repro.tune.measure import Measurer as JMeasurer  # noqa: E402
from repro.tune.plan import param_fingerprint as jfingerprint  # noqa: E402
from repro.tune.plan import quantized_leaf_items as jleaf_items  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import LutLinearSpec  # noqa: E402
from repro_torch.core.calibrate import calibrate_tree  # noqa: E402
from repro_torch.ft import supervisor as sup  # noqa: E402
from repro_torch.models.model import build_model, prepare_params  # noqa: E402
from repro_torch.serve.ops import LiveServer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402
from repro_torch.tune import Measurer, plan_model, verify_capacity  # noqa: E402
from repro_torch.tune.plan import param_fingerprint, quantized_leaf_items  # noqa: E402
from repro_torch.tune.planner import apply_plan  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "zamba2-7b", "rwkv6-3b", "whisper-large-v3"]
# Plan A leaves some leaves raw (p = 1) and prepares the rest at p = 4 on
# every family; plan B prepares every leaf at p = 5 (the same tokens: the
# int-lut family).
BUDGET_A, BUDGET_B = 64 * 1024, 256 * 1024
N_HINT = BATCH = 2
MAX_SEQ = 32
PROMPTS, BUDGETS = (3, 5, 7), (4, 3, 5)     # ragged: wave 1 admits the third request
SPEC = dict(bw=1, ba=3, mode="lut")

_LAUNCHER_TREES: dict = {}


def _launcher_tree(arch):
    """The reference launcher's raw tree at the f32 smoke config (its dicts in
    ``init``'s insertion order; built once a module)."""
    if arch not in _LAUNCHER_TREES:
        jm = jbuild(dataclasses.replace(jget_config(arch, smoke=True), dtype="float32"))
        _LAUNCHER_TREES[arch] = (jm, jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**SPEC)))
    return _LAUNCHER_TREES[arch]


def _requests(cfg, cls=Request, lens=PROMPTS, budgets=BUDGETS, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=m)
            for n, m in zip(lens, budgets)]


def _calibrated(tm, tree):
    """The port's tree with every leaf's activation scale frozen on a seeded
    batch (whisper's through frames: its forward needs them, in both
    packages)."""
    cfg = tm.cfg
    toks = torch.from_numpy(np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    if cfg.is_encdec:
        frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32))
        return calibrate_tree(lambda p: tm.forward(p, toks, prefix_embeds=frames)[0], tree)
    return calibrate_tree(lambda p: tm.forward(p, toks)[0], tree)


class _Family:
    """One family's trees, plans and (lazily) the reference's serves."""

    def __init__(self, arch):
        self.arch = arch
        self.jm, self.jq = _launcher_tree(arch)
        self.cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        self.tm = build_model(self.cfg)
        self.mla = self.cfg.attn_kind == "mla"
        self.tq = params_from_numpy(self.jq, device="cpu")
        kw = dict(n_hint=N_HINT, measure=False)
        self.jplan = jplanner.plan_model(self.jq, lut_budget_bytes=BUDGET_A, **kw)
        self.plan_a = plan_model(self.tq, lut_budget_bytes=BUDGET_A, **kw)
        self.plan_b = plan_model(self.tq, lut_budget_bytes=BUDGET_B, **kw)
        self._ref: dict = {}
        self._planned: dict = {}
        self._cal = None
        self._cal_tokens = None

    def reference_engine(self, decode="scan"):
        """The reference's engine (its planned tree; deepseek's raw tree) and
        its serve of the ragged requests: (engine, tokens, admissions, host
        syncs), built once per driver."""
        if decode not in self._ref:
            kw = {} if self.mla else dict(plan=self.jplan)
            eng = JServeEngine(self.jm, self.jq, batch=BATCH, max_seq=MAX_SEQ, decode=decode, **kw)
            outs = eng.generate(_requests(self.cfg, JRequest))
            self._ref[decode] = (eng, outs, list(eng.admissions), eng.host_syncs)
        return self._ref[decode]

    def planned_serve(self, decode="scan"):
        """The port's ``ServeEngine(plan=)`` (plan A) and its serve of the ragged
        requests: (engine, tokens), built once per driver."""
        if decode not in self._planned:
            eng = self.engine(decode=decode)
            self._planned[decode] = (eng, eng.generate(_requests(self.cfg)))
        return self._planned[decode]

    def reference_prepared(self):
        """The reference's tree prepared under its plan A: its scan engine's
        where that engine serves the plan (``ServeEngine(plan=)`` prepares
        with the plan's ``n_hint``, ``N_HINT``), else ``Model.prepare``."""
        if self.mla:
            return self.jm.prepare(self.jq, plan=self.jplan, n_hint=N_HINT)
        return self.reference_engine("scan")[0].params

    def engine(self, tree=None, plan="a", **kw):
        plan = {"a": self.plan_a, "b": self.plan_b, None: None}[plan]
        return ServeEngine(self.tm, self.tq if tree is None else tree, batch=BATCH,
                           max_seq=MAX_SEQ, plan=plan, device="cpu", **kw)

    @property
    def calibrated(self):
        if self._cal is None:
            self._cal = _calibrated(self.tm, self.tq)
        return self._cal

    @property
    def calibrated_tokens(self):
        """The calibrated tree's unplanned prepared serve of the requests."""
        if self._cal_tokens is None:
            tree = prepare_params(self.calibrated, n_hint=N_HINT)
            self._cal_tokens = self.engine(tree, plan=None).generate(_requests(self.cfg))
        return self._cal_tokens


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return _Family(request.param)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of this module on one torch thread (its smoke shapes
    gain nothing from more, and the test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the launchers' walk order ----------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-12b", *FAMILIES])
def test_init_quantized_walks_in_the_reference_launchers_order(arch):
    """The port's ``init_quantized`` tree walks its quantized leaves in the
    order of the reference launcher's ``Model.quantize(Model.init(key))``
    and carries its ``param_fingerprint``: a stack's dict keys sorted (the
    reference stacks with ``jax.tree.map``), every other dict in ``init``'s
    insertion order (whisper's segments before its encoder; zamba2's shared
    block ``wq`` before ``wk``)."""
    _jm, jq = _launcher_tree(arch)
    tq = build_model(get_config(arch, smoke=True)).init_quantized(LutLinearSpec(**SPEC),
                                                                  device="cpu")
    assert [p for p, _ in quantized_leaf_items(tq)] == [p for p, _ in jleaf_items(jq)]
    assert param_fingerprint(tq) == jfingerprint(jq)
    assert param_fingerprint(params_from_numpy(jq, device="cpu")) == jfingerprint(jq)


def test_restore_keeps_the_saved_trees_walk_order(tmp_path):
    """``ckpt.restore`` rebuilds each dict in its ``like`` tree's key order
    (the files hold the leaves in jax's sorted order): a restored whisper
    tree walks its quantized leaves as the saved one and keeps its
    fingerprint."""
    from repro_torch.tree import tree_map

    tq = build_model(get_config("whisper-large-v3", smoke=True)).init_quantized(
        LutLinearSpec(**SPEC), device="cpu")
    ckpt.save(str(tmp_path), 0, tq)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tq)
    back = ckpt.restore(str(tmp_path), 0, like, device="cpu")
    assert [p for p, _ in quantized_leaf_items(back)] == [p for p, _ in quantized_leaf_items(tq)]
    assert param_fingerprint(back) == param_fingerprint(tq)
    assert list(back) == list(tq) and list(back)[2] == "segments"


def test_launch_tune_writes_the_reference_launchers_plan(tmp_path, monkeypatch):
    """``repro_torch.launch.tune --arch zamba2-7b --smoke --analytic --device
    cpu`` and the reference's launcher with the same flags write one plan:
    the same fingerprint and the same JSON but ``meta``."""
    from repro.launch import tune as jtune
    from repro_torch.launch import tune as ltune

    flags = ["--arch", "zamba2-7b", "--smoke", "--analytic"]
    plan = ltune.main([*flags, "--device", "cpu", "--out", str(tmp_path / "t.json")])
    monkeypatch.setattr(sys, "argv", ["tune", *flags, "--out", str(tmp_path / "j.json")])
    jtune.main()
    got, want = (json.load(open(tmp_path / n)) for n in ("t.json", "j.json"))
    assert got["fingerprint"] == want["fingerprint"] == plan.fingerprint
    got.pop("meta"), want.pop("meta")
    assert got == want


# --- plans ------------------------------------------------------------------


def test_analytic_plan_equals_reference_and_applies(fam):
    """``plan_model(measure=False)``: the reference's plan, JSON for JSON
    apart from ``meta`` (fingerprint, paths, modes, p, stacks, capacity,
    totals), with expert stacks, MLA's ``W_kup`` / ``W_vup``, zamba2's shared
    leaves and whisper's encoder and cross leaves priced as the reference
    prices them; at least two p values, some leaves raw.  ``apply_plan``
    refuses a foreign fingerprint, and ``verify_capacity`` holds on the
    applied tree."""
    got, want = json.loads(fam.plan_a.to_json()), json.loads(fam.jplan.to_json())
    got.pop("meta"), want.pop("meta")
    assert got == want
    assert fam.plan_a.fingerprint == jfingerprint(fam.jq)
    ps = {lp.p for lp in fam.plan_a.layers.values()}
    assert len(ps) >= 2 and any(not lp.prepared for lp in fam.plan_a.layers.values())
    assert {lp.p for lp in fam.plan_b.layers.values()} == {5}
    foreign = dataclasses.replace(fam.plan_a, fingerprint="0" * 32)
    with pytest.raises(ValueError, match="fingerprint"):
        apply_plan(fam.tq, foreign)
    applied = apply_plan(fam.tq, fam.plan_a)
    actual = verify_capacity(applied, fam.plan_a)
    assert sum(actual.values()) + fam.plan_a.table_bytes == fam.plan_a.total_bytes


def test_measured_plan_times_every_stack_on_its_first_unit(fam):
    """``plan_model(measure=True)`` times each candidate on a stacked leaf's
    first unit, an expert stack's and the shared block's too, and a stack of
    one as well: deepseek's ``"F"`` segment and zamba2's ``"M"`` remainder
    are such stacks.  The reference slices only where the stack is larger
    than one, and its measured plan raises at deepseek's first leaf
    (``src/repro/tune/planner.py:142``; ROADMAP Queue 3, reference defect
    7).  The port's measured plan prices every leaf and applies."""
    meas = Measurer(iters=1, warmup=0, cache={})
    plan = plan_model(fam.tq, lut_budget_bytes=BUDGET_A, n_hint=N_HINT, measure=True,
                      measurer=meas, p_cap=4)
    assert plan.fingerprint == fam.plan_a.fingerprint and meas.misses > 0
    assert all(lp.measured_us is not None for lp in plan.layers.values())
    verify_capacity(apply_plan(fam.tq, plan), plan)
    if fam.arch == "deepseek-v2-lite-16b":
        with pytest.raises(ValueError, match="too many values to unpack"):
            jplanner.plan_model(fam.jq, lut_budget_bytes=BUDGET_A, n_hint=N_HINT, measure=True,
                                measurer=JMeasurer(iters=1, warmup=0, cache={}), p_cap=4)


@pytest.mark.parametrize("decode", ["scan", "loop"])
def test_planned_serve_gives_the_reference_tokens(fam, decode):
    """``ServeEngine(plan=)`` with the same driver: the reference's tokens,
    admissions and host syncs (deepseek: the reference's raw tree)."""
    _jeng, want, admissions, syncs = fam.reference_engine(decode)
    eng, got = fam.planned_serve(decode)
    assert got == want
    assert eng.admissions == admissions and eng.host_syncs == syncs
    assert [len(o) for o in want] == list(BUDGETS)


def test_calibrated_planned_serve_equals_the_unplanned_serve(fam):
    """Inside the int-lut family a plan never changes the tokens: the
    calibrated tree served under plan A gives the unplanned prepared serve's
    tokens bit for bit (plan B's tree: the hot-swap test)."""
    got = fam.engine(fam.calibrated).generate(_requests(fam.cfg))
    assert got == fam.calibrated_tokens


# --- prepared checkpoints ---------------------------------------------------


def test_prepared_checkpoint_is_the_reference_file_for_file_and_round_trips(fam, tmp_path):
    """The planned f32 tree saved by both packages: the same manifest and
    byte-identical leaf files (expert stacks and shared packs charged as the
    reference charges them); the port's restore rebuilds the packs and serves
    the planned serve's tokens."""
    eng, want = fam.planned_serve("scan")
    dj = jck.save_prepared(str(tmp_path / "j"), 0, fam.reference_prepared())
    dt = ckpt.save_prepared(str(tmp_path / "t"), 0, eng.params)
    assert json.load(open(os.path.join(dj, "manifest.json"))) == \
        json.load(open(os.path.join(dt, "manifest.json")))
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    assert [n for n in names if not filecmp.cmp(os.path.join(dj, n), os.path.join(dt, n),
                                                shallow=False)] == []
    meta = ckpt.prepared_meta(str(tmp_path / "t"), 0)
    assert meta["fingerprint"] == fam.plan_a.fingerprint
    restored = ckpt.restore_prepared(str(tmp_path / "t"), 0, device="cpu",
                                     expect_fingerprint=fam.plan_a.fingerprint)
    verify_capacity(restored, fam.plan_a)
    assert fam.engine(restored, plan=None).generate(_requests(fam.cfg)) == want


# --- hot-swap -----------------------------------------------------------------


def test_hot_swap_between_plans_is_token_identical(fam):
    """Mid-serve, the calibrated tree under plan A is swapped at a wave
    boundary for the same tree under plan B: every request to its budget,
    the unplanned serve's tokens.  A tree of other shapes is refused with
    its diagnostic and the active tree is untouched."""
    want = fam.calibrated_tokens
    eng = fam.engine(fam.calibrated)
    tree_a = eng.params
    tree_b = apply_plan(fam.calibrated, fam.plan_b, n_hint=N_HINT)

    def on_wave(rec):
        if rec.wave == 0:
            eng.request_swap(tree_b)
            assert eng.params is tree_a

    eng.on_wave = on_wave
    assert eng.generate(_requests(fam.cfg)) == want
    assert eng.swaps == 1 and eng.last_swap_wave == 1 and eng.params is tree_b
    wide = build_model(dataclasses.replace(fam.cfg, d_ff=2 * fam.cfg.d_ff))
    other = prepare_params(wide.init_quantized(LutLinearSpec(**SPEC), device="cpu"),
                           n_hint=N_HINT)
    with pytest.raises(ValueError, match="incompatible hot-swap refused"):
        eng.request_swap(other)
    assert eng.params is tree_b and eng.swaps == 1
    eng.on_wave = None
    assert eng.generate(_requests(fam.cfg)) == want


# --- kill + replay ------------------------------------------------------------


def test_kill_and_replay_equals_the_reference_live_server(fam, tmp_path):
    """Killed at wave 1 and replayed: no request dropped, each its exact
    budget, and the reference's ``LiveServer`` tokens under the same
    injected failure (the reference's planned tree; deepseek's raw tree)."""
    jeng, _want, _adm, _syncs = fam.reference_engine("scan")
    jsrv = JLiveServer(lambda: jeng, log_path=str(tmp_path / "j.jsonl"),
                       injector=jsup.FailureInjector(fail_at_waves=(1,)))
    want = jsrv.serve(_requests(fam.cfg, JRequest))
    srv = LiveServer(lambda: fam.engine(), log_path=str(tmp_path / "t.jsonl"),
                     injector=sup.FailureInjector(fail_at_waves=(1,)))
    got = srv.serve(_requests(fam.cfg))
    assert srv.restarts == jsrv.restarts == 1
    assert got == want and [len(o) for o in got] == list(BUDGETS)


def test_kill_and_replay_identity(fam, tmp_path):
    """Where the replay computes each row as the clean serve did, a kill +
    replay gives the clean serve's tokens.  whisper: any requests (full
    caches, no MoE).  zamba2 and rwkv6: rows of one prompt length, no
    bucketing, so neither the waves nor the replay pad a row.  deepseek: the
    same waves and its calibrated tree on a dropless copy (capacity_factor
    64: the capacity no longer cuts rows by the call's token count)."""
    tm, tree = fam.tm, fam.calibrated
    if fam.cfg.is_encdec:
        reqs, kw, fail = _requests(fam.cfg), dict(batch=BATCH), (1,)
    else:
        # wave 0 admits all three; the third finishes, the other two replay
        # at prompt + 2 emitted tokens: one length, no pad
        reqs = _requests(fam.cfg, lens=(8, 8, 8), budgets=(6, 6, 2))
        kw, fail = dict(batch=3, prompt_bucket=1), (0,)
        if fam.cfg.moe is not None:
            tm = build_model(dataclasses.replace(
                fam.cfg, moe=dataclasses.replace(fam.cfg.moe, capacity_factor=64.0)))

    def factory():
        return ServeEngine(tm, prepare_params(tree, n_hint=N_HINT), max_seq=MAX_SEQ,
                           device="cpu", **kw)

    clean = factory().generate(reqs)
    srv = LiveServer(factory, log_path=str(tmp_path / "log.jsonl"),
                     injector=sup.FailureInjector(fail_at_waves=fail))
    got = srv.serve(reqs)
    assert srv.restarts == 1
    assert [len(o) for o in got] == [r.max_new_tokens for r in reqs]
    assert got == clean
