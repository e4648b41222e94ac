"""Port parity: training (``repro_torch.train``: the loss, autograd's
gradients, AdamW) against the JAX reference on numpy-seeded inputs at the
smoke widths, f32 (CPU).

The loss within 1e-5 relative and every leaf's gradient within 1e-4 x its
max |g| against the reference's ``jax.value_and_grad(loss_fn)`` under
``jax.jit`` (each unit checkpointed in both) on chatglm3 (dense), deepseek-v2-lite
(MoE aux and MLA), zamba2 (Mamba2 + shared block), rwkv6, whisper (frames
through the encoder) and internvl2 (patches, their positions dropped before
the loss); whisper's key biases, whose gradient is zero in exact arithmetic
(no RoPE: the softmax cancels them), are held below 1e-6 x the tree's max
|g| in both.  The optimizer is held on *the same* gradients (the reference's):
after one AdamW step a parameter moves by about ``lr * sign(g)``, so a
near-zero gradient that differs in its last bit may flip it, and post-step
parameters of two packages that computed their own gradients are not
compared."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

TOL_LOSS = 1e-5       # relative
TOL_GRAD = 1e-4       # per leaf, relative to the leaf's max |g|
ZERO_GRAD = 1e-6      # a gradient that is zero in exact arithmetic (a key bias's),
                      # relative to the tree's max |g|: rounding noise in both packages
B, S = 2, 12


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _batch(cfg, seed=0, b=B, s=S):
    """Tokens [b, s + 1] and, with a frontend, its f32 embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)}
    if cfg.frontend is not None:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pairs(jtree, ttree):
    """(path, reference leaf, port leaf) for every leaf, in the reference's
    order (the port's trees keep their dict keys sorted)."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            tl.append(t)

    walk(ttree)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), np.asarray(a), b) for (p, a), b in zip(jl, tl)]


def _pad_patterns(cfg):
    """(pattern, units) of both packages' segmentation agree."""
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr

    assert jtr.segments(cfg) == ttr.segments(cfg)


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-v2-lite-16b", "zamba2-7b",
                                  "rwkv6-3b", "whisper-large-v3", "internvl2-1b"])
def test_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    _pad_patterns(jcfg)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg, seed=1)
    jloss_fn = jts.make_loss_fn(jm, remat=True)
    (jl, jx), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tparams = params_from_numpy(_np(jparams), device="cpu")
    (tl, tx), tg = ts.value_and_grad(ts.make_loss_fn(tm, remat=True), tparams, _t(batch))
    assert tl.shape == () and bool(torch.isfinite(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL_LOSS)
    np.testing.assert_allclose(float(tx["moe_aux"]), float(jx["moe_aux"]), rtol=TOL_LOSS,
                               atol=1e-7)
    if jcfg.moe is not None:
        assert float(tx["moe_aux"]) > 0
    bad = []
    pairs = _pairs(jg, tg)
    top = max(np.abs(want).max() for _p, want, _g in pairs)
    for path, want, got in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32, path
        if jcfg.rope_kind == "none" and path.endswith("['wk']['b']"):
            # Without RoPE a key bias adds one constant to every score of a
            # query row, which the softmax cancels: its gradient is zero in
            # exact arithmetic, and both packages give rounding noise far
            # below the tree's gradients.
            noise = max(np.abs(want).max(), got.abs().max().item())
            if noise > ZERO_GRAD * top:
                bad.append(f"{path}: {noise:.3e} > {ZERO_GRAD} x {top:.3e}")
            continue
        scale = np.abs(want).max()
        err = np.abs(got.numpy() - want).max()
        if err > TOL_GRAD * max(scale, 1e-30):
            bad.append(f"{path}: {err:.3e} > {TOL_GRAD} x {scale:.3e}")
    assert not bad, bad[:5]
    if jcfg.frontend is not None:
        assert np.abs(np.asarray(jg["frontend_proj"]["w"])).max() > 0


def test_remat_leaves_loss_and_gradients_unchanged():
    """Checkpointing each unit (and each head chunk) recomputes the same
    values: the loss and gradients with ``remat=True`` equal those without,
    bit for bit."""
    _jc, tcfg = _cfgs("deepseek-v2-lite-16b")
    tm = tmodel.build_model(tcfg)
    params = tm.init(3, device="cpu")
    batch = _t(_batch(tcfg, seed=4))
    (la, _), ga = ts.value_and_grad(ts.make_loss_fn(tm, remat=True), params, batch)
    (lb, _), gb = ts.value_and_grad(ts.make_loss_fn(tm, remat=False), params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree.tensors(ga), tree.tensors(gb)))


# ---------------------------------------------------------------------------
# AdamW on the same gradients
# ---------------------------------------------------------------------------


def test_apply_updates_on_reference_gradients_within_ulps():
    """Two AdamW steps (warmup, clipping at a norm the gradients exceed,
    decay of the stacked leaves) on the reference's own gradients, from the
    reference's converted state: parameters, moments, step and metrics
    within a few f32 ulps."""
    jcfg, _tcfg = _cfgs("chatglm3-6b")
    jm = jmodel.build_model(jcfg)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=3, clip_norm=0.5)
    jcfg_opt = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    jstate = jts.init_train_state(jm, jax.random.PRNGKey(0))
    grad_fn = jax.jit(jax.value_and_grad(jts.make_loss_fn(jm, remat=False), has_aux=True))
    japply = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jcfg_opt))
    jp, jo = jstate.params, jstate.opt
    tstate = train_state_from_numpy(_np(jstate), device="cpu")
    tp, to = tstate.params, tstate.opt
    for i in range(2):
        _, jg = grad_fn(jp, jax.tree.map(jnp.asarray, _batch(jcfg, seed=10 + i)))
        tg = params_from_numpy(_np(jg), device="cpu")
        jp, jo, jmet = japply(jp, jg, jo)
        tp, to, tmet = opt.apply_updates(tp, tg, to, cfg)
        assert float(jmet["grad_norm"]) > cfg.clip_norm
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=4e-7)
        assert float(tmet["lr"]) == float(jmet["lr"])
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for tree_j, tree_t in ((jp, tp), (jo["mu"], to["mu"]), (jo["nu"], to["nu"])):
            for path, want, got in _pairs(tree_j, tree_t):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max() + 1e-30,
                                           err_msg=path)
    # A stacked norm scale [n_units, d] (ndim 2) decays in both packages.
    g0 = np.asarray(jstate.params["segments"][0]["s0_D"]["attn_norm"]["g"])
    assert g0.ndim == 2
    assert not np.array_equal(tp["segments"][0]["s0_D"]["attn_norm"]["g"].numpy(), g0)


def test_init_opt_state_and_schedule():
    params = {"a": torch.ones((3, 4)), "b": [torch.ones(5)]}
    st = opt.init_opt_state(params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 and not t.any() for t in tree.tensors(st["mu"]))
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=4)
    lrs = [float(opt._schedule(cfg, torch.tensor(s, dtype=torch.int32))) for s in (1, 2, 4, 9)]
    want = [float(jopt._schedule(jopt.AdamWConfig(lr=1e-3, warmup_steps=4), jnp.int32(s)))
            for s in (1, 2, 4, 9)]
    assert lrs == want


# ---------------------------------------------------------------------------
# The chunked head, gradient accumulation, the loss falling
# ---------------------------------------------------------------------------


def test_chunked_head_equals_unchunked():
    """At a vocabulary of 32768 and S = 512 the head runs in two checkpointed
    chunks of 256 (the reference's condition); its loss and gradients equal
    the unchunked head's within 1e-5 / 1e-4 x max |g|."""
    tcfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), dtype="float32",
                               vocab_size=32768)
    params = {k: v for k, v in tmodel.build_model(tcfg).init(0, device="cpu").items()
              if k in ("embed", "lm_head")}
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn((1, 512, tcfg.d_model), generator=g)
    tgt = torch.randint(0, tcfg.vocab_size, (1, 512), generator=g)

    def run(fn):
        leaves = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
        h = hidden.clone().requires_grad_(True)
        loss = fn(leaves, h)
        grads = torch.autograd.grad(loss, [h, *tree.tensors(leaves)], allow_unused=True)
        return loss.detach(), grads

    from repro_torch.models import transformer

    lc, gc = run(lambda p, h: ts.chunked_head_xent(p, tcfg, h, tgt))
    lu, gu = run(lambda p, h: ts.cross_entropy(transformer.lm_head(p, tcfg, h), tgt))
    np.testing.assert_allclose(float(lc), float(lu), rtol=TOL_LOSS)
    for a, b in zip(gc, gu):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=TOL_GRAD * b.abs().max().item())


def _pattern_batch(vocab, b, s, seed):
    """Learnable data: token_{t+1} = (token_t + 1) % vocab."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, (b, 1))
    seq = (start + np.arange(s + 1)[None, :]) % vocab
    return {"tokens": torch.from_numpy(seq.astype(np.int32))}


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 gradients == full-batch gradients (the same update):
    the mirror of tests/test_system.py's."""
    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), vocab_size=64)
    model = tmodel.build_model(cfg)
    state = ts.init_train_state(model, 0, device="cpu")
    batch = _pattern_batch(64, 8, 12, 0)
    s1, m1 = ts.make_train_step(model, opt.AdamWConfig(lr=1e-3), remat=False)(state, batch)
    s2, m2 = ts.make_train_step(model, opt.AdamWConfig(lr=1e-3), remat=False,
                                accum_steps=2)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree.tensors(s1.params), tree.tensors(s2.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-4, atol=2e-5)


def test_training_reduces_loss():
    """The mirror of tests/test_system.py::test_training_reduces_loss."""
    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), vocab_size=32)
    model = tmodel.build_model(cfg)
    state = ts.init_train_state(model, 0, device="cpu")
    step = ts.make_train_step(model, opt.AdamWConfig(lr=3e-3, warmup_steps=5), remat=False)
    losses = []
    for i in range(30):
        state, m = step(state, _pattern_batch(32, 8, 12, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses[::6]
    assert int(state.step) == 30 and int(state.opt["step"]) == 30


@pytest.mark.parametrize("arch", sorted(__import__("repro_torch.configs", fromlist=["x"]).ARCH_IDS))
def test_smoke_train_step(arch):
    """The mirror of tests/test_models_smoke.py::test_smoke_train_step: one
    step of the port's own train step on each smoke config (its own dtype,
    remat on): a finite loss, step 1, parameters moved."""
    cfg = get_config(arch, smoke=True)
    model = tmodel.build_model(cfg)
    state = ts.init_train_state(model, 0, device="cpu")
    step = ts.make_train_step(model, opt.AdamWConfig(lr=1e-3), remat=True)
    new_state, metrics = step(state, _t(_batch(cfg)))
    assert np.isfinite(float(metrics["loss"]))
    assert int(new_state.step) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree.tensors(state.params), tree.tensors(new_state.params))]
    assert max(moved) > 0


def test_sharding_context_refused():
    """``make_train_step(ctx=)`` builds (sharded training runs on process
    groups: tests/test_torch_sharded.py); a ctx whose mesh has none refuses
    when the step runs."""
    from repro_torch.dist import AxisMesh, ShardCtx

    model = tmodel.build_model(get_config("chatglm3-6b", smoke=True))
    step = ts.make_train_step(model, opt.AdamWConfig(),
                              ctx=ShardCtx(AxisMesh((1, 2), ("data", "model"))))
    state = ts.init_train_state(model, 0, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        step(state, {"tokens": torch.zeros((2, 5), dtype=torch.long)})
