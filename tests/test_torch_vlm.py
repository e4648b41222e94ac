"""Port parity: internvl2-1b's VLM branch (the stub vision frontend's patch
embeddings, projected by ``frontend_proj`` and prepended to the tokens)
against the JAX reference on numpy-seeded inputs at its smoke widths (3
layers, d_model 56, 7 / 1 heads of 8, 8 patches of 32), f32 unless stated
(CPU).

The forward with patches (logits over P + S positions) and the prefill with
patches followed by decode steps at offsets from P + S, against the
reference's same calls and the port's own forward, within 1e-4 x max
|logit|; the reference's left-padded prefill, whose ``pad_len`` masks the
first buffer positions — the patches, not the pad tokens — reproduced, not
fixed; the patches cast to a bf16 model's dtype before the projection;
``ServeEngine`` (text only: the reference's ``Request`` carries no patches)
per driver; ``check_supported`` admitting every config.  The reference's
calls run under ``jax.jit``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.serving import Request as JRequest  # noqa: E402
from repro.serve.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402

ARCH = "internvl2-1b"
TOL = 1e-4            # f32: the same sums in another order, relative to max |logit|
B = 2

jforward = jax.jit(lambda cfg, params, toks, pe: jtransformer.forward(
    params, cfg, toks, prefix_embeds=pe)[0], static_argnums=0)
jprefill = jax.jit(lambda cfg, params, toks, caches, pe, pad: jtransformer.forward(
    params, cfg, toks, caches=caches, pos=jnp.int32(0), prefix_embeds=pe, is_prefill=True,
    last_token_only=True, pad_len=pad)[:2], static_argnums=0)
jdecode = jax.jit(lambda cfg, params, tok, caches, pos, pad: jtransformer.forward(
    params, cfg, tok, caches=caches, pos=pos, pad_len=pad)[:2], static_argnums=0)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _toks(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _patches(cfg, seed=5):
    """Stub frontend patch embeddings [B, frontend_seq, frontend_dim], f32."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jraw = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jraw, tm, params_from_numpy(_np(jraw), device="cpu")


@pytest.fixture(scope="module")
def pallas_pair(models):
    """The reference's W4A4 pallas tree (raw leaves) and the port's copy."""
    jcfg, jm, jraw, _tm, _tp = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="pallas"))
    return jq, params_from_numpy(_np(jq), device="cpu")


@pytest.mark.parametrize("kind", ["raw", "pallas"])
def test_forward_with_patches_matches_reference(models, pallas_pair, kind):
    """Logits over the P + S positions of the forward with patches, against
    the reference's over its raw tree and its W4A4 pallas tree
    (``frontend_proj`` stays dense in both)."""
    jcfg, _jm, jraw, tm, traw = models
    jtree, ttree = (jraw, traw) if kind == "raw" else pallas_pair
    assert isinstance(ttree["frontend_proj"], dict)
    toks, pe = _toks(jcfg, (B, 9)), _patches(jcfg)
    want = jforward(jcfg, jtree, jnp.asarray(toks), jnp.asarray(pe))
    got, caches = tm.forward(ttree, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pe))
    assert caches is None
    assert got.shape == (B, jcfg.frontend_seq + 9, jcfg.vocab_size) == want.shape
    _close(got, want)


def test_prefill_with_patches_then_decode_matches_reference_and_forward(models):
    """A prefill of 5 tokens with the 8 patches fills P + 5 cache positions;
    decode steps follow at offsets P + 5 .. P + 9.  Each call against the
    reference's same call, and against the port's own forward over all
    P + 10 positions, within 1e-4 x max |logit|."""
    jcfg, jm, jraw, tm, tp = models
    P, S, PRE = jcfg.frontend_seq, 10, 5
    toks, pe = _toks(jcfg, (B, S), seed=1), _patches(jcfg, 7)
    full, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pe))
    jc = jm.init_cache(B, 24, jnp.float32)
    jpf, jc = jprefill(jcfg, jraw, jnp.asarray(toks[:, :PRE]), jc, jnp.asarray(pe), None)
    caches = tm.init_cache(B, 24, torch.float32, device="cpu")
    pf, caches = tm.prefill(tp, torch.from_numpy(toks[:, :PRE]), caches,
                            prefix_embeds=torch.from_numpy(pe))
    assert pf.shape == (B, 1, jcfg.vocab_size)
    _close(pf, jpf)
    _close(pf[:, 0], full[:, P + PRE - 1].numpy())
    k = caches[0]["s0_D"]["k"]
    assert bool(k[:, :, : P + PRE].abs().sum(dim=(0, 1, 3, 4)).gt(0).all())
    assert not k[:, :, P + PRE :].any()                       # nothing past P + S written
    _close(k, jc[0]["s0_D"]["k"])
    for t in range(PRE, S):
        jlg, jc = jdecode(jcfg, jraw, jnp.asarray(toks[:, t : t + 1]), jc, jnp.int32(P + t), None)
        lg, caches = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), caches, P + t)
        _close(lg, jlg)
        _close(lg[:, 0], full[:, P + t].numpy())


def test_left_padded_prefill_masks_the_patches_as_the_reference_does(models):
    """The reference's trap, reproduced and not fixed: under ``pad_len`` the
    key mask drops the first ``pad_len`` *buffer* positions, which with
    patches prepended are patches, not the pad tokens, and the logical
    positions shift the patches too.  A prompt of 4 tokens left-padded to 7
    (pads 3 and 1) then gives the reference's logits (prefill and decode
    steps, within 1e-4 x max |logit|), not the unpadded prompt's; the
    masked patches can be changed without changing the logits, the pad
    tokens cannot."""
    jcfg, jm, jraw, tm, tp = models
    P, S = jcfg.frontend_seq, 7
    pad = np.array([3, 1], dtype=np.int32)
    toks, pe = _toks(jcfg, (B, S), seed=11), _patches(jcfg, 12)

    def port(toks_, pe_):
        caches = tm.init_cache(B, 24, torch.float32, device="cpu")
        pf, caches = tm.prefill(tp, torch.from_numpy(toks_), caches,
                                prefix_embeds=torch.from_numpy(pe_), pad_len=torch.from_numpy(pad))
        return pf, caches

    jc = jm.init_cache(B, 24, jnp.float32)
    jpf, jc = jprefill(jcfg, jraw, jnp.asarray(toks), jc, jnp.asarray(pe), jnp.asarray(pad))
    pf, caches = port(toks, pe)
    _close(pf, jpf)
    tok = toks[:, -1:]
    for i in range(3):
        jlg, jc = jdecode(jcfg, jraw, jnp.asarray(tok), jc, jnp.int32(P + S + i), jnp.asarray(pad))
        lg, caches = tm.decode_step(tp, torch.from_numpy(tok), caches, P + S + i,
                                    pad_len=torch.from_numpy(pad))
        _close(lg, jlg)
        tok = np.asarray(jnp.argmax(jlg[:, -1:], axis=-1)).astype(np.int32)
    # Row 1's real prompt alone (its last 6 tokens), unpadded: other logits.
    cu = tm.init_cache(1, 24, torch.float32, device="cpu")
    unpadded, _ = tm.prefill(tp, torch.from_numpy(toks[1:, 1:]), cu,
                             prefix_embeds=torch.from_numpy(pe[1:]))
    scale = pf.abs().max().item()
    assert (unpadded[0] - pf[1]).abs().max().item() > TOL * scale
    # The first pad_len patches are don't-cares; the pad tokens are attended.
    pe2 = pe.copy()
    pe2[0, :3] += 5.0
    pe2[1, :1] += 5.0
    masked, _ = port(toks, pe2)
    assert torch.equal(masked, pf)
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 1) % jcfg.vocab_size
    attended, _ = port(toks2, pe)
    assert (attended[0] - pf[0]).abs().max().item() > TOL * scale


def test_patches_cast_to_the_model_dtype_before_the_projection():
    """Unlike whisper's frames, a VLM's patches are cast to the model's dtype
    (reference :442): under a bf16 config, f32 patches and the same patches
    rounded to bf16 give bit-equal logits in each package, and the hidden
    states are bf16."""
    jcfg, tcfg = _cfgs("bfloat16")
    jraw = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jraw), device="cpu")
    tm = tmodel.build_model(tcfg)
    toks, pe = _toks(jcfg, (B, 6)), _patches(jcfg)
    j32 = np.asarray(jforward(jcfg, jraw, jnp.asarray(toks), jnp.asarray(pe)))
    j16 = np.asarray(jforward(jcfg, jraw, jnp.asarray(toks), jnp.asarray(pe, jnp.bfloat16)))
    np.testing.assert_array_equal(j32, j16)
    pt = torch.from_numpy(pe)
    t32, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=pt)
    t16, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=pt.to(torch.bfloat16))
    assert torch.equal(t32, t16) and t32.dtype == torch.float32
    hidden, _ = tm.forward(tp, torch.from_numpy(toks), prefix_embeds=pt, return_hidden=True)
    assert hidden.dtype == torch.bfloat16 and hidden.shape == (B, jcfg.frontend_seq + 6,
                                                               jcfg.d_model)


@pytest.fixture(scope="module")
def served_pair(models):
    """W4A4 "dequant", prepared in both packages (the reference's "pallas"
    runs its kernel in interpret mode: slow to serve; the port's pallas path
    is held to it by test_forward_with_patches_matches_reference)."""
    jcfg, jm, jraw, tm, _tp = models
    jq = jm.quantize(jraw, JSpec(bw=4, ba=4, mode="dequant"))
    return jcfg, jm, jm.prepare(jq, n_hint=B), tm, tm.prepare(
        params_from_numpy(_np(jq), device="cpu"))


@pytest.mark.parametrize("decode", ["scan", "chunked", "loop"])
def test_serve_text_only_matches_reference_under_every_driver(served_pair, decode):
    """The reference's ServeEngine serves a VLM text only (its Request has no
    patches): on prompts of 5 / 8 / 3 / 6 / 2 tokens each driver's tokens,
    admissions, host syncs and bucket counts equal the reference's."""
    jcfg, jm, jp, tm, tp = served_pair
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, jcfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip((5, 8, 3, 6, 2), (4, 6, 3, 5, 2))]
    jeng = JServeEngine(jm, jp, batch=2, max_seq=32, decode=decode)
    teng = ServeEngine(tm, tp, batch=2, max_seq=32, decode=decode, device="cpu")
    got = teng.generate(reqs)
    assert got == jeng.generate([JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                                 for r in reqs])
    assert [len(o) for o in got] == [4, 6, 3, 5, 2]
    assert teng.admissions == jeng.admissions
    assert teng.host_syncs == jeng.host_syncs
    assert teng.bucket_counts == jeng.bucket_counts


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_check_supported_admits_every_config(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    transformer.check_supported(cfg)


def test_launch_serve_vlm_smoke():
    """``launch.serve --arch internvl2-1b --smoke --mode pallas --device cpu``
    serves its requests text only."""
    from repro_torch.launch import serve as lserve

    lserve.main(["--arch", ARCH, "--smoke", "--mode", "pallas", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "5", "--max-new", "3"])
