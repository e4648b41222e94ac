"""Port parity: the attention helpers of repro_torch.models.attention against
the JAX reference's (repro.models.attention) on the same numpy-seeded inputs
(CPU): int8 row quantization and the ring-buffer write bit for bit, the
bf16-operand attend within 1e-6 x max |out|, and gqa_attention's ring, int8
and bf16 branches on one layer."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL_BF16 = 1e-6      # bf16-operand attend, relative to max |out|: the same exact
                     # products summed in another order in f32
TOL_LAYER = 1e-5     # one attention layer in f32, relative to max |y|


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((2, 5, 3, 16), 1.0), ((1, 9, 2, 32), 300.0),
                                         ((3, 1, 4, 8), 1e-3)])
def test_quant_rows_bit_equal_to_reference(shape, scale):
    x = _normal(np.random.default_rng(sum(shape)), shape, scale)
    x[0, 0, 0] = 0.0                                  # an all-zero row: the 1e-8 floor
    x[0, -1, -1, :4] = [127.0, 2.5, -3.5, 0.5]        # scale 1: halves round to even
    x[0, -1, -1, 4:] = 0.0
    jc, js = jax.jit(jattn._quant_rows)(jnp.asarray(x))    # as the reference serves it
    tc, ts = tattn._quant_rows(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tc[0, -1, -1, :4]) == [127, 2, -4, 0]


@pytest.mark.parametrize("start,tail", [(0, 6), (5, 3), (13, 8), ("per_slot", 1),
                                        ("per_slot_wide", 4)])
def test_ring_update_bit_equal_to_reference(start, tail):
    """Int starts (prefill: the last ``tail`` tokens, wrapping past W) and
    per-slot [B] starts (continuous-batching decode), written in place."""
    rng = np.random.default_rng(tail)
    b, w, s = 3, 8, 10
    cache = _normal(rng, (b, w, 2, 4))
    new = _normal(rng, (b, s, 2, 4))
    if start == "per_slot":
        gs = np.array([0, 7, 21], np.int32)           # slot 7, a wrap to 5
    elif start == "per_slot_wide":
        gs = np.array([6, 3, 15], np.int32)           # tails that cross the end
    else:
        gs = start
    want = np.asarray(jattn._ring_update(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.asarray(gs) if isinstance(gs, np.ndarray) else gs,
                                         tail))
    t_cache = torch.from_numpy(cache.copy())
    got = tattn._ring_update(t_cache, torch.from_numpy(new),
                             torch.from_numpy(gs) if isinstance(gs, np.ndarray) else gs, tail)
    assert got is t_cache                              # in place
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, cache)


def _attend_inputs(seed, b=2, s=16, t=16, h=4, hkv=2, hd=32):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, s, h, hd), 2.0), _normal(rng, (b, t, hkv, hd), 2.0),
            _normal(rng, (b, t, hkv, hd)))


@pytest.mark.parametrize("softcap,window", [(50.0, None), (None, 5), (30.0, 7)])
def test_attend_bf16_operands_matches_reference(softcap, window):
    q, k, v = _attend_inputs(int(softcap or 0) + (window or 0))
    jm = jattn.causal_mask(16, 16, window=window)
    tm = tattn.causal_mask(16, 16, window=window)
    want = np.asarray(jattn._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                                    softcap_val=softcap, bf16_operands=True))
    got = tattn._attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        mask=tm, softcap_val=softcap, bf16_operands=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_BF16 * np.abs(want).max())
    # and it is another function than the f32 attend
    f32 = tattn._attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        mask=tm, softcap_val=softcap)
    assert (f32 - got).abs().max().item() > 100 * TOL_BF16 * np.abs(want).max()


@pytest.mark.parametrize("bf16", [False, True])
def test_attend_chunked_matches_reference(bf16):
    """The query-chunked long-prefill path (S = 2 x CHUNK_SIZE, reached
    through the function itself) with left padding.  f32: within 1e-5 x max
    |out|.  bf16 operands over 1024 keys: a probability whose f32 value
    differs in its last bits between the packages may round to the next bf16
    value (one bf16 ulp, 2^-8 of it), so the output is held within 2^-8 x
    max |v|, the bound if every probability of a row did."""
    q, k, v = _attend_inputs(3, b=2, s=2 * tattn.CHUNK_SIZE, t=2 * tattn.CHUNK_SIZE, h=2,
                             hkv=1, hd=16)
    pad = np.array([0, 37], np.int32)
    pos = (np.arange(q.shape[1])[None] - pad[:, None]).astype(np.int32)
    want = np.asarray(jattn._attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), window=300,
        softcap_val=50.0, causal=True, bf16_operands=bf16, pad_len=jnp.asarray(pad)))
    got = tattn._attend_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        window=300, softcap_val=50.0, causal=True, bf16_operands=bf16,
        pad_len=torch.from_numpy(pad))
    tol = 2.0**-8 * np.abs(v).max() if bf16 else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# gqa_attention's cached branches on one gemma2-2b smoke layer (window 8,
# softcap 50), f32, weights from the reference's init
# ---------------------------------------------------------------------------


def _layer(**kw):
    jcfg = dataclasses.replace(jget_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32", **kw)
    jp = jattn.gqa_init(jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _cache(b, t, hkv, hd, int8):
    if int8:
        return {"k": np.zeros((b, t, hkv, hd), np.int8), "k_s": np.zeros((b, t, hkv), np.float32),
                "v": np.zeros((b, t, hkv, hd), np.int8), "v_s": np.zeros((b, t, hkv), np.float32)}
    return {"k": np.zeros((b, t, hkv, hd), np.float32), "v": np.zeros((b, t, hkv, hd), np.float32)}


@pytest.mark.parametrize("branch", ["ring", "ring_per_slot", "int8", "int8_bf16", "plain_bf16",
                                    "long_prefill"])
def test_gqa_attention_cached_branches_match_reference(branch):
    """Prefill 11 left-padded tokens, then 6 decode steps; ``ring*``: a
    cache of W = 8 slots (the window), so prefill keeps the last 8 tokens
    and decode wraps; ``int8``: codes and scales written and read back;
    ``long_prefill``: 4608 tokens, where the reference attends over the
    cache in query chunks and the port in its row-invariant blocks, then 2
    steps.  Every output and every cache leaf against the reference's."""
    bf16 = branch.endswith("bf16")
    jcfg, tcfg, jp, tp = _layer(attend_bf16=bf16)
    b, s, steps = 2, 11, 6
    if branch == "long_prefill":
        s, steps = tattn.CHUNK_THRESHOLD + tattn.CHUNK_SIZE, 2
    t = jcfg.window if branch.startswith("ring") else s + steps
    rng = np.random.default_rng(len(branch))
    pad = np.array([0, 3], np.int32)
    xs = _normal(rng, (b, s + steps, jcfg.d_model))
    jc = {k: jnp.asarray(v) for k, v in _cache(b, t, jcfg.n_kv_heads, jcfg.hd,
                                               branch.startswith("int8")).items()}
    tc = {k: torch.from_numpy(v) for k, v in _cache(b, t, jcfg.n_kv_heads, jcfg.hd,
                                                    branch.startswith("int8")).items()}
    window = jcfg.window if branch != "plain_bf16" else None

    def step(x, pos, positions):
        nonlocal jc, tc
        jy, jc = jattn.gqa_attention(jp, jnp.asarray(x), cfg=jcfg,
                                     positions=jnp.asarray(positions), cache=jc,
                                     pos=jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos,
                                     window=window, pad_len=jnp.asarray(pad))
        ty, tc = tattn.gqa_attention(tp, torch.from_numpy(x), cfg=tcfg,
                                     positions=torch.from_numpy(positions), cache=tc,
                                     pos=torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos,
                                     window=window, pad_len=torch.from_numpy(pad))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want, rtol=0, atol=TOL_LAYER * np.abs(want).max())
        assert sorted(tc) == sorted(jc)
        for key in jc:
            w = np.asarray(jc[key])
            assert tc[key].numpy().dtype == w.dtype, key
            if w.dtype == np.int8:       # codes of values equal within 1e-5: at most one step
                assert np.abs(tc[key].numpy().astype(int) - w.astype(int)).max() <= 1, key
            else:
                np.testing.assert_allclose(tc[key].numpy(), w, rtol=0,
                                           atol=TOL_LAYER * max(np.abs(w).max(), 1e-30))

    positions = (np.arange(s)[None] - pad[:, None]).astype(np.int32)
    step(xs[:, :s], 0, positions)
    for i in range(steps):
        p = s + i
        pos = np.full((b,), p, np.int32) if branch == "ring_per_slot" else p
        step(xs[:, p : p + 1], pos, (np.full((b, 1), p) - pad[:, None]).astype(np.int32))


def test_unported_attention_kinds_raise():
    """Cross attention is ported (tests/test_torch_whisper.py); a config
    without attention is refused unless every unit is an RWKV "R" unit."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), attn_kind="none")
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.check_supported(cfg)


def test_quant_rows_equal_to_jitted_reference_at_served_shape():
    """The int8 KV cache's rows at a served shape ([4, 512, 4, 256] f32): the
    codes and scales of the reference's ``_quant_rows`` as it serves it,
    under ``jax.jit`` (XLA multiplies by ``f32(1/127)``), bit for bit; the
    eager quotient differs from it in the last bit of some scales."""
    x = _normal(np.random.default_rng(0), (4, 512, 4, 256), 3.0)
    jc, js = jax.jit(jattn._quant_rows)(jnp.asarray(x))
    tc, ts = tattn._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _ec, es = jattn._quant_rows(jnp.asarray(x))
    assert (np.asarray(es) != np.asarray(js)).sum() > 0     # the eager scales are another function


def test_int8_cache_after_served_prefill_matches_reference(monkeypatch):
    """One prefill as ``ServeEngine`` serves it on gemma2-2b smoke under the
    serve profile (f32, ``max_seq`` 32 > the window 8: ring "L" caches, int8
    "G" caches), on converted weights.  Every K / V block the port quantizes
    is written as the reference's jitted ``_quant_rows`` writes it, codes and
    scales bit for bit; and the int8 leaves (``k``, ``v``, ``k_s``, ``v_s``)
    agree with the reference's jitted ``Model.prefill`` as far as its f32 K / V
    do: the projections sum in another order in each package and the drift
    grows through the layer below (the f32 ring leaves differ in their last
    bits), so the scales are held to the reference's f32 tolerance, 1e-4 of
    the largest, and a code may move by one step at a rounding boundary."""
    from repro.models.model import build_model as jbuild
    from repro.models.profiles import apply_perf_profile as japply
    from repro_torch.models.model import build_model
    from repro_torch.models.profiles import apply_perf_profile as tapply

    jcfg = japply(dataclasses.replace(jget_config("gemma2-2b", smoke=True), dtype="float32"),
                  "serve")
    tcfg = tapply(dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32"),
                  "serve")
    assert tcfg.kv_cache_int8 and tcfg.ring_window_cache
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    pad = np.array([0, 5], np.int32)
    quantized = []
    port_quant_rows = tattn._quant_rows

    def recording(x):
        out = port_quant_rows(x)
        quantized.append((x.numpy().copy(),) + tuple(t.numpy().copy() for t in out))
        return out

    monkeypatch.setattr(tattn, "_quant_rows", recording)
    _jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jm.init_cache(2, 32, jnp.float32),
                                  pad_len=jnp.asarray(pad))
    _tl, tc = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(2, 32, torch.float32,
                                                                   device="cpu"),
                         pad_len=torch.from_numpy(pad))
    served = jax.jit(jattn._quant_rows)
    eager_differs = 0
    n_global = sum(tu[name]["k"].shape[0] for tu in tc for name in tu if name.endswith("_G"))
    assert n_global > 0 and len(quantized) == 2 * n_global     # K and V of every "G" unit
    for x, codes, scale in quantized:
        jcodes, jscale = served(jnp.asarray(x))
        np.testing.assert_array_equal(codes, np.asarray(jcodes))
        np.testing.assert_array_equal(scale, np.asarray(jscale))
        eager_differs += int((np.asarray(jattn._quant_rows(jnp.asarray(x))[1]) != scale).sum())
    assert eager_differs > 0            # the eager quotient would not have passed
    compared = 0
    for ju, tu in zip(jc, tc):
        for name in tu:
            if name.endswith("_G"):
                assert sorted(tu[name]) == ["k", "k_s", "v", "v_s"]
                for leaf in ("k_s", "v_s"):
                    want = np.asarray(ju[name][leaf])
                    np.testing.assert_allclose(tu[name][leaf].numpy(), want, rtol=0,
                                               atol=1e-4 * np.abs(want).max())
                for leaf in ("k", "v"):
                    got = tu[name][leaf].numpy().astype(np.int32)
                    want = np.asarray(ju[name][leaf]).astype(np.int32)
                    assert np.abs(got - want).max() <= 1 and (got != want).mean() < 1e-2
                compared += 1
    assert compared == len(tc)


@pytest.mark.parametrize("window,softcap,bf16", [(None, None, False), (9, 30.0, False),
                                                 (None, 30.0, True), (40, None, True)])
@pytest.mark.parametrize("s", [33, 70, 128])
def test_cache_invariant_attend_is_the_same_function_and_row_invariant(s, window, softcap,
                                                                       bf16):
    """The full-cache branch's attention (``_attend_cache_invariant``) against
    the reference's function, ``_attend`` over the cache with ``_key_mask``:
    f32 within 1e-5 x max |out|; bf16 operands within 2^-8 x max |v| (a
    probability's f32 value may differ in its last bit and round to the next
    bf16 value), with under 1% of the outputs off by more than 1e-6 x max
    |out|.  At S that spans several blocks of
    ``INVARIANT_ROWS`` and ends in a part-filled one; and a query row's bits
    the same whether it comes with the others or alone, in another block, and
    whatever its row's left pad."""
    rng = np.random.default_rng(11 + s + (window or 0))
    b, t, hkv, rep, hd = 3, 160, 2, 2, 16
    assert s > tattn.INVARIANT_ROWS and (s % tattn.INVARIANT_ROWS or s == 128)
    q = _normal(rng, (b, s, hkv * rep, hd), 2.0)
    kc = _normal(rng, (b, t, hkv, hd), 2.0)
    vc = _normal(rng, (b, t, hkv, hd))
    pad = np.array([0, 5, 11], np.int32)
    positions = (np.arange(s)[None] + 7 - pad[:, None]).astype(np.int32)     # logical
    jm = jattn._key_mask(jnp.arange(t)[None], jnp.asarray(positions)[:, :, None],
                         jnp.asarray(pad), window)
    want = np.asarray(jattn._attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    mask=jm[:, None], softcap_val=softcap,
                                    bf16_operands=bf16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    tpos, tpad = torch.from_numpy(positions), torch.from_numpy(pad)
    got = tattn._attend_cache_invariant(tq, tk, tv, tpos, window=window, softcap_val=softcap,
                                        bf16_operands=bf16, pad_len=tpad)
    assert got.shape == (b, s, hkv * rep, hd) and got.dtype == torch.float32
    if bf16:    # a probability may round to the next bf16 value, as in the chunked test
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0**-8 * np.abs(vc).max())
        assert (np.abs(got.numpy() - want) > TOL_BF16 * np.abs(want).max()).mean() < 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL_LAYER * np.abs(want).max())
    pad2 = torch.tensor([3, 0, 2])               # the same keys behind other pads
    idx = (torch.arange(t)[None] - pad2[:, None] + tpad[:, None]) % t
    rows = torch.arange(b)[:, None]
    for sl in (slice(s - 1, s), slice(0, 20), slice(tattn.INVARIANT_ROWS - 3, s)):
        part = tattn._attend_cache_invariant(tq[:, sl], tk[rows, idx], tv[rows, idx],
                                             tpos[:, sl], window=window, softcap_val=softcap,
                                             bf16_operands=bf16, pad_len=pad2)
        assert torch.equal(part, got[:, sl])


def _shards(tp: int):
    from repro_torch.dist.runtime import SeqShard

    return [SeqShard(r, tp) for r in range(tp)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("start,tail", [(0, 6), (5, 3), (13, 8), ("per_slot", 1),
                                        ("per_slot_wide", 4)])
def test_sequence_sharded_ring_update_equals_reference(tp, start, tail):
    """The ring write over sequence-sharded slots: each rank writes the slots
    it holds of a ring of ``W = n·tp``; the ranks' slices side by side are the
    reference's ring bit for bit (int starts that wrap across ranks, per-slot
    starts)."""
    rng = np.random.default_rng(tail + tp)
    b, w, s = 3, 8, 10
    cache = _normal(rng, (b, w, 2, 4))
    new = _normal(rng, (b, s, 2, 4))
    gs = {"per_slot": np.array([0, 7, 21], np.int32),
          "per_slot_wide": np.array([6, 3, 15], np.int32)}.get(start, start)
    want = np.asarray(jattn._ring_update(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.asarray(gs) if isinstance(gs, np.ndarray) else gs,
                                         tail))
    tgs = torch.from_numpy(gs) if isinstance(gs, np.ndarray) else gs
    n = w // tp
    parts = []
    for seq in _shards(tp):
        local = torch.from_numpy(cache[:, seq.lo(n) : seq.lo(n) + n].copy())
        assert tattn._ring_update(local, torch.from_numpy(new), tgs, tail, seq) is local
        parts.append(local)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pos", [0, 3, 9, "per_slot"])
def test_sequence_sharded_cache_write_equals_reference(tp, pos):
    """The cache write over sequence slices: an int offset's range cut to each
    rank's slice, a per-slot ``[B]`` offset written only where the rank
    holds it; the slices side by side are the reference's write."""
    rng = np.random.default_rng(tp)
    b, t = 3, 16
    cache = _normal(rng, (b, t, 2, 4))
    s = 1 if pos == "per_slot" else 6
    new = _normal(rng, (b, s, 2, 4))
    p = np.array([2, 7, 15], np.int32) if pos == "per_slot" else pos
    want = np.asarray(jattn._cache_write(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.asarray(p) if pos == "per_slot" else p))
    n = t // tp
    parts = []
    for seq in _shards(tp):
        local = torch.from_numpy(cache[:, seq.lo(n) : seq.lo(n) + n].copy())
        tattn._cache_write(local, torch.from_numpy(new),
                           torch.from_numpy(p) if pos == "per_slot" else p, seq)
        parts.append(local)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("window,softcap,bf16", [(None, None, False), (9, 30.0, False),
                                                 (None, 30.0, True)])
def test_context_parallel_attend_over_shards_matches_reference(tp, window, softcap, bf16):
    """The full-cache branch over ``tp`` slices of the sequence, combined in one
    process with the function the collective path combines with
    (``runtime.combine``): against the reference's ``_attend`` over the whole
    cache with ``_key_mask``, to the bounds of the unsharded form.  The first
    rows of each padded row have no valid key anywhere (uniform weights, as
    unsharded) and the later slices none for most rows: no NaN.  A row's bits
    are the same alone or among other rows of its call (the same pad); behind
    another pad (the same keys at other buffer positions, so other slice
    boundaries) they are held only to the tolerance."""
    from repro_torch.dist.runtime import combine

    rng = np.random.default_rng(17 + tp + (window or 0))
    b, t, hkv, rep, hd, s = 3, 160, 2, 2, 16, 70
    q = _normal(rng, (b, s, hkv * rep, hd), 2.0)
    kc = _normal(rng, (b, t, hkv, hd), 2.0)
    vc = _normal(rng, (b, t, hkv, hd))
    pad = np.array([0, 5, 11], np.int32)
    positions = (np.arange(s)[None] - pad[:, None]).astype(np.int32)     # pads: logical < 0
    jm = jattn._key_mask(jnp.arange(t)[None], jnp.asarray(positions)[:, :, None],
                         jnp.asarray(pad), window)
    want = np.asarray(jattn._attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    mask=jm[:, None], softcap_val=softcap,
                                    bf16_operands=bf16))
    tq, tpos, tpad = torch.from_numpy(q), torch.from_numpy(positions), torch.from_numpy(pad)
    n = t // tp

    def attend(qq, kk, vv, pp, pad_len):
        return tattn._attend_cache_shards(
            qq, list(kk.split(n, 1)), list(vv.split(n, 1)), [r * n for r in range(tp)], pp,
            window=window, softcap_val=softcap, bf16_operands=bf16, pad_len=pad_len,
            reduce=combine)

    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got = attend(tq, tk, tv, tpos, tpad)
    assert got.shape == (b, s, hkv * rep, hd) and torch.isfinite(got).all()
    if bf16:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0**-8 * np.abs(vc).max())
        assert (np.abs(got.numpy() - want) > TOL_BF16 * np.abs(want).max()).mean() < 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL_LAYER * np.abs(want).max())
    for sl in (slice(s - 1, s), slice(0, 20), slice(tattn.INVARIANT_ROWS - 3, s)):
        assert torch.equal(attend(tq[:, sl], tk, tv, tpos[:, sl], tpad), got[:, sl])
    pad2 = torch.tensor([3, 0, 2])               # the same keys behind other pads
    idx = (torch.arange(t)[None] - pad2[:, None] + tpad[:, None]) % t
    rows = torch.arange(b)[:, None]
    moved = attend(tq, tk[rows, idx], tv[rows, idx], tpos, pad2)
    np.testing.assert_allclose(moved.numpy(), got.numpy(), rtol=0,
                               atol=TOL_LAYER * np.abs(want).max())
