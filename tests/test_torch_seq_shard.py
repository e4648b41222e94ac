"""``seq_shard``: which cache leaves the rule cuts along dim 2 at published
widths, and the context-parallel attention on the card.

On the CPU, in one process: ``runtime._seq_layout`` (the shapes and cuts
``cache_specs`` gives the caches of a config at ``max_seq`` under
``seq_shard``) cuts exactly the leaves the attention and RWKV6 branches take
sharded — every sequence dim of at least 1024 positions that tp divides, and
rwkv6's token-shift rows, whose dim 2 is the feature dim — at tp 2, 4 and 8.
The multi-rank semantics are in ``tests/test_torch_sharded.py`` (its 4-rank
gloo world), the attention over shards held in one process against the
reference in ``tests/test_torch_attention.py``.

On the card (``-m cuda``; no JAX needed): the shards' partials combined by
``runtime.combine`` against the unsharded full-cache attention on bf16
caches at tp 2 and 4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist import runtime  # noqa: E402
from repro_torch.models import attention  # noqa: E402

MAX_SEQ = 32768


def _cut(cfg, tp: int) -> dict:
    """``{leaf path: (global shape, cut)}`` of ``cfg``'s caches at MAX_SEQ."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            out[path] = node

    walk(runtime._seq_layout(cfg, MAX_SEQ, tp), "")
    return out


def _want_cut(name, shape, tp):
    """The rule, leaf by leaf: dim 2 — the sequence of a K / V / latent /
    scale leaf, the encoder's frames of a cross cache, the feature dim of
    rwkv6's token-shift rows — where it is at least 1024 and tp divides it;
    never a recurrent state."""
    return name not in ("ssd", "conv", "s") and shape[2] >= 1024 and shape[2] % tp == 0


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_layout_cuts_the_rules_leaves_at_published_widths(arch, tp):
    leaves = _cut(get_config(arch), tp)
    assert leaves
    for path, (shape, cut) in leaves.items():
        name = path.rsplit("/", 1)[-1]
        assert cut == _want_cut(name, shape, tp), (path, shape, cut)
        if cut:
            assert name in runtime._SEQ_LEAVES, path
    names = {p.rsplit("/", 1)[-1] for p, (_s, cut) in leaves.items() if cut}
    if arch == "rwkv6-3b":                    # [32, B, 2560]: the feature dim, cut at every tp
        assert names == {"x_prev_t", "x_prev_c"}
    if arch == "whisper-large-v3":            # 1500 frames: cut at tp 2 and 4, not at 8
        assert ("ck" in names) == (tp != 8) and "k" in names
    if arch == "zamba2-7b":                   # the shared attention's K / V only
        assert names == {"k", "v"}
    if arch == "deepseek-v2-lite-16b":
        assert names == {"ckv", "krope"}


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_context_parallel_combine_matches_unsharded(tp):
    """bf16 caches on the card, the query in f32 (bf16 values): the shards'
    partials (``_attend_cache_shards``) combined by ``runtime.combine``
    against ``_attend_cache_invariant`` over the whole cache — f32 operands
    within 2e-4 x max |y| (the f32 attention tolerance), bf16 operands within
    2^-8 x max |v| (a probability may round to the next bf16 value); finite,
    with the last shard at tp 4 holding no valid key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's run of the context-parallel attention")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(tp)
    b, t, hkv, rep, hd, s = 2, 4096, 4, 2, 112, 40
    q = torch.randn((b, s, hkv * rep, hd), generator=gen, device=dev).bfloat16().float()
    kc = torch.randn((b, t, hkv, hd), generator=gen, device=dev).bfloat16()
    vc = torch.randn((b, t, hkv, hd), generator=gen, device=dev).bfloat16()
    pad = torch.tensor([0, 37], device=dev)
    positions = 2900 + torch.arange(s, device=dev)[None] - pad[:, None]   # keys < 3072
    n = t // tp
    for bf16 in (False, True):
        kw = dict(window=None, softcap_val=30.0, bf16_operands=bf16, pad_len=pad)
        want = attention._attend_cache_invariant(q, kc, vc, positions, **kw)
        got = attention._attend_cache_shards(q, list(kc.split(n, 1)), list(vc.split(n, 1)),
                                             [r * n for r in range(tp)], positions,
                                             reduce=runtime.combine, **kw)
        assert torch.isfinite(got).all()
        tol = 2.0**-8 * vc.float().abs().max() if bf16 else 2e-4 * want.abs().max()
        assert (got - want).abs().max() <= tol, (tp, bf16)
