"""Port parity: repro_torch.dist (sharding specs, shard_tree, compressed_psum,
the mesh builders, pipeline_apply) against the JAX reference's repro.dist,
in one process (CPU).

* ``param_specs`` equals the reference's leaf for leaf on all ten smoke
  configs, dense and raw-quantized (W4A4), with fsdp off and on, on a
  ``(data 4, model 2)`` mesh and a ``(pod 2, data 2, model 2)`` one with
  ``dp_axes=("pod", "data")`` (the reference's on jax 0.9's
  ``AbstractMesh(axis_sizes, axis_names)``); a quantized leaf's ``ascale``
  spec is the port's one difference, pinned here;
* the assertions of ``tests/test_dist_units.py`` (which does not collect
  under jax 0.9: its ``AbstractMesh`` call takes the old form), each held in
  both packages;
* ``shard_tree``: every rank's shard of every leaf, for every coordinate;
* ``compressed_psum`` bit for bit against the reference under ``jax.vmap``:
  the real function on a one-rank gloo group, and n = 2, 4, 8 participants
  through its own steps with the two all-reduces taken over the stacked
  participants (the n-rank collectives themselves run in
  ``tests/test_torch_sharded.py``);
* the mesh builders' refusals, ``pipeline_apply`` on one stage, and the
  refusals of a sharded call (``seq_shard``, a prepared tree handed to
  ``param_specs``).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.core import QuantizedLinear as JQuantizedLinear  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist.collectives import compressed_psum as jcompressed_psum  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import LutLinearSpec, QuantizedLinear  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    AxisMesh, PSpec, ShardCtx, cache_specs, param_specs, pipeline_apply, shard_tree,
    to_shardings,
)
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.dist.sharding import global_like  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402

W4A4 = dict(bw=4, ba=4)
MESHES = {
    "data4_model2": ((4, 2), ("data", "model"), ("data",)),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
}


def _ctxs(mesh: str, **kw):
    sizes, names, dp = MESHES[mesh]
    return (jshd.ShardCtx(mesh=AbstractMesh(sizes, names), dp_axes=dp, **kw),
            ShardCtx(AxisMesh(sizes, names), dp_axes=dp, **kw))


@pytest.fixture
def gloo1(monkeypatch):
    """A one-rank gloo world (the default group) for the test's duration."""
    import torch.distributed as dist

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# param_specs parity on the model zoo
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(arch: str, quantized: bool):
    """Both packages' parameter trees of one smoke config: the reference's
    as shapes (``eval_shape``), the port's quantized on the CPU (its dense
    tree on the meta device)."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    if quantized:
        jp = jax.eval_shape(lambda: jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(**W4A4)))
        tp = tm.init_quantized(LutLinearSpec(**W4A4), device="cpu")
    else:
        jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        tp = tm.init(device="meta")
    return jcfg, tcfg, jp, tp


def _spec_pairs(js, ts, path="$"):
    """(path, reference entries, port entries) over two spec trees, checking
    that they have one structure."""
    if isinstance(js, P):
        assert isinstance(ts, PSpec), (path, ts)
        yield path, tuple(js), tuple(ts)
    elif isinstance(js, JQuantizedLinear):
        assert isinstance(ts, QuantizedLinear), (path, ts)
        for f in ("codes", "scale", "bias"):
            yield from _spec_pairs(getattr(js, f), getattr(ts, f), f"{path}.{f}")
    elif isinstance(js, dict):
        assert sorted(js) == sorted(ts), path
        for k in js:
            yield from _spec_pairs(js[k], ts[k], f"{path}/{k}")
    elif isinstance(js, (list, tuple)):
        assert len(js) == len(ts), path
        for i, (a, b) in enumerate(zip(js, ts)):
            yield from _spec_pairs(a, b, f"{path}[{i}]")
    else:
        assert js is None and ts is None, (path, js, ts)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "w4a4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, quantized, fsdp, mesh):
    jcfg, tcfg, jp, tp = _trees(arch, quantized)
    jctx, tctx = _ctxs(mesh, fsdp=fsdp)
    pairs = list(_spec_pairs(jshd.param_specs(jcfg, jp, jctx), param_specs(tcfg, tp, tctx)))
    bad = [(p, a, b) for p, a, b in pairs if a != b]
    assert not bad, bad[:5]
    assert sum(e is not None for _p, a, _b in pairs for e in a) > 0
    # The specs recomputed from any rank's shard (what a sharded call does)
    # are the same tree.
    coords = dict.fromkeys(MESHES[mesh][1], 1)
    local = shard_tree(tp, param_specs(tcfg, tp, tctx), tctx, coords=coords) \
        if quantized else tp
    again = param_specs(tcfg, global_like(tcfg, local), tctx)
    assert [b for _p, _a, b in _spec_pairs(jshd.param_specs(jcfg, jp, jctx), again)] \
        == [b for _p, _a, b in pairs]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["stablelm-12b", "zamba2-7b", "whisper-large-v3"])
def test_cache_specs_equal_reference(arch, mesh):
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jc = jax.eval_shape(lambda: jmodel.build_model(jcfg).init_cache(4, 2048))
    tc = tmodel.build_model(tcfg).init_cache(4, 2048, device="meta")
    for seq_shard in (False, True):
        jctx, tctx = _ctxs(mesh, seq_shard=seq_shard)
        pairs = list(_spec_pairs(jshd.cache_specs(jcfg, jc, jctx), cache_specs(tcfg, tc, tctx)))
        assert pairs and all(a == b for _p, a, b in pairs), pairs


def test_ascale_spec_is_replicated_where_the_reference_keeps_the_array():
    """The one difference: the reference's spec tree holds a calibrated
    leaf's ``ascale`` array itself (``dataclasses.replace`` touches only
    codes, scale and bias); the port's holds a replicated spec."""
    _jcfg, tcfg, _jp, tp = _trees("stablelm-12b", True)
    jcfg = jget_config("stablelm-12b", smoke=True)
    jq = JQuantizedLinear(codes=jnp.zeros((2, 16, 8), jnp.uint8), scale=jnp.zeros((2, 16)),
                          bias=None, spec=JSpec(**W4A4), k=16, ascale=jnp.ones((2,)))
    tq = QuantizedLinear(codes=torch.zeros((2, 16, 8), dtype=torch.uint8),
                         scale=torch.zeros((2, 16)), bias=None, spec=LutLinearSpec(**W4A4),
                         k=16, ascale=torch.ones((2,)))
    jctx, tctx = _ctxs("data4_model2")
    js = jshd.param_specs(jcfg, {"wq": jq}, jctx)["wq"]
    ts = param_specs(tcfg, {"wq": tq}, tctx)["wq"]
    assert js.ascale is jq.ascale
    assert ts.ascale == PSpec(None)
    assert tuple(js.codes) == tuple(ts.codes) == (None, "model", None)


def test_param_specs_refuse_a_prepared_tree():
    _jcfg, tcfg, _jp, tp = _trees("stablelm-12b", True)
    prepared = tmodel.prepare_params(tp)
    with pytest.raises(TypeError, match="shard_tree"):
        param_specs(tcfg, prepared, ShardCtx(AxisMesh((1, 2), ("data", "model"))))


# ---------------------------------------------------------------------------
# tests/test_dist_units.py's assertions, in both packages
# ---------------------------------------------------------------------------


def _cfg_pair(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=64)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _moe_cfgs():
    moe = dict(n_experts=4, n_shared_experts=0, top_k=2, d_ff_expert=8, capacity_factor=1.0)
    jcfg, tcfg = _cfg_pair(family="moe")
    return (dataclasses.replace(jcfg, moe=JMoEConfig(**moe)),
            dataclasses.replace(tcfg, moe=MoEConfig(**moe)))


def _both(shapes, quantized_leaves=None):
    """A reference tree (jnp zeros) and a port tree (torch zeros) of the same
    nested shapes; ``quantized_leaves`` maps a path to ``(f, kp, lead, bias)``."""

    def build(node, zeros, qlin):
        if isinstance(node, dict):
            return {k: build(v, zeros, qlin) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, zeros, qlin) for v in node]
        if isinstance(node, tuple) and node and node[0] == "q":
            return qlin(*node[1:])
        return zeros(node)

    def jq(f, kp, lead=(), bias=False):
        return JQuantizedLinear(
            codes=jnp.zeros(tuple(lead) + (f, kp), jnp.uint8),
            scale=jnp.zeros(tuple(lead) + (f,), jnp.float32),
            bias=jnp.zeros(tuple(lead) + (f,), jnp.float32) if bias else None,
            spec=JSpec(**W4A4), k=2 * kp)

    def tq(f, kp, lead=(), bias=False):
        return QuantizedLinear(
            codes=torch.zeros(tuple(lead) + (f, kp), dtype=torch.uint8),
            scale=torch.zeros(tuple(lead) + (f,)),
            bias=torch.zeros(tuple(lead) + (f,)) if bias else None,
            spec=LutLinearSpec(**W4A4), k=2 * kp)

    return (build(shapes, lambda s: jnp.zeros(s), jq),
            build(shapes, lambda s: torch.zeros(s), tq))


def _specs(cfgs, shapes, mesh="data4_model2", **kw):
    jp, tp = _both(shapes)
    jctx, tctx = _ctxs(mesh, **kw)
    js, ts = jshd.param_specs(cfgs[0], jp, jctx), param_specs(cfgs[1], tp, tctx)
    pairs = list(_spec_pairs(js, ts))
    assert all(a == b for _p, a, b in pairs), pairs
    return ts


def _case_ctx_sizes():
    jctx, tctx = _ctxs("data4_model2")
    assert (jctx.dp_size(), jctx.tp_size()) == (tctx.dp_size(), tctx.tp_size()) == (4, 2)
    j2, t2 = _ctxs("data4_model2")
    j2, t2 = dataclasses.replace(j2, dp_axes=("pod", "data")), \
        dataclasses.replace(t2, dp_axes=("pod", "data"))
    assert j2.dp_size() == t2.dp_size() == 4                      # a missing axis is 1
    assert jshd.ShardCtx(mesh=None).dp_size() == ShardCtx(mesh=None).dp_size() == 1


def _case_col_and_row():
    ts = _specs(_cfg_pair(), {"wq": {"w": (2, 16, 16), "b": (2, 16)}, "wo": {"w": (2, 16, 16)}})
    assert ts["wq"]["w"] == (None, None, "model") and ts["wq"]["b"] == (None, "model")
    assert ts["wo"]["w"] == (None, "model", None)


def _case_divisibility():
    assert _specs(_cfg_pair(), {"wq": {"w": (15, 15)}}, fsdp=True)["wq"]["w"] == (None, None)
    assert _specs(_cfg_pair(), {"wq": {"w": (16, 15)}}, fsdp=True)["wq"]["w"] == ("data", None)


def _case_fsdp_non_tp_dim():
    shapes = {"wq": {"w": (2, 16, 16)}}
    assert _specs(_cfg_pair(), shapes, fsdp=True)["wq"]["w"] == (None, "data", "model")
    assert _specs(_cfg_pair(), shapes)["wq"]["w"] == (None, None, "model")


def _case_embed():
    assert _specs(_cfg_pair(), {"embed": (64, 16)})["embed"] == ("model", None)
    assert _specs(_cfg_pair(), {"embed": (63, 16)})["embed"] == (None, None)


def _case_moe_experts():
    shapes = {"moe": {"router": {"w": (16, 4)}, "w_gate": (2, 4, 16, 8),
                      "w_up": (2, 4, 16, 8), "w_down": (2, 4, 8, 16)}}
    ts = _specs(_moe_cfgs(), shapes)
    assert ts["moe"]["w_gate"] == ts["moe"]["w_down"] == (None, "model", None, None)
    shapes["moe"]["w_gate"] = (2, 3, 16, 8)
    assert _specs(_moe_cfgs(), shapes)["moe"]["w_gate"] == (None, None, None, None)


def _case_quantized_output_dim():
    ts = _specs(_cfg_pair(), {"wq": ("q", 16, 8, (2,), True)}, fsdp=True)
    assert isinstance(ts["wq"], QuantizedLinear)
    assert (ts["wq"].codes, ts["wq"].scale, ts["wq"].bias) == \
        ((None, "model", None), (None, "model"), (None, "model"))


def _case_quantized_odd_output_dim():
    ts = _specs(_cfg_pair(), {"wq": ("q", 15, 8)})
    assert (ts["wq"].codes, ts["wq"].scale) == ((None, None), (None,))


def _case_quantized_experts():
    ts = _specs(_cfg_pair(), {"moe": {"w_up": ("q", 8, 4, (2, 4))}})
    assert ts["moe"]["w_up"].codes == (None, "model", None, None)
    assert ts["moe"]["w_up"].scale == (None, "model", None)
    ts = _specs(_cfg_pair(), {"moe": {"w_up": ("q", 8, 4, (2, 3))}})
    assert ts["moe"]["w_up"].codes == (None, None, None, None)


def _case_cache_specs():
    jcfg, tcfg = _cfg_pair()
    shapes = [{"s0_D": {"k": (2, 4, 2048, 2, 8), "v": (2, 4, 2048, 2, 8)}}]
    for seq_shard, want in ((True, (None, "data", "model", None, None)),
                            (False, (None, "data", None, None, None))):
        jctx, tctx = _ctxs("data4_model2", seq_shard=seq_shard)
        jc, tc = _both(shapes)
        assert tuple(jshd.cache_specs(jcfg, jc, jctx)[0]["s0_D"]["k"]) == want
        assert cache_specs(tcfg, tc, tctx)[0]["s0_D"]["k"] == want
    jctx, tctx = _ctxs("data4_model2", seq_shard=True)
    jc, tc = _both([{"s0_M": {"conv": (2, 4, 16, 4)}}])
    assert cache_specs(tcfg, tc, tctx)[0]["s0_M"]["conv"] == (None, "data", None, None) \
        == tuple(jshd.cache_specs(jcfg, jc, jctx)[0]["s0_M"]["conv"])
    jctx, tctx = _ctxs("data4_model2")
    jc, tc = _both([{"s0_D": {"k": (2, 3, 2048, 2, 8)}}])
    assert cache_specs(tcfg, tc, tctx)[0]["s0_D"]["k"] == (None,) * 5 \
        == tuple(jshd.cache_specs(jcfg, jc, jctx)[0]["s0_D"]["k"])


DIST_UNITS = {
    "ctx_sizes_from_abstract_mesh": _case_ctx_sizes,
    "param_specs_tp_shards_col_and_row_projections": _case_col_and_row,
    "param_specs_divisibility_falls_back_to_replication": _case_divisibility,
    "param_specs_fsdp_shards_non_tp_dim": _case_fsdp_non_tp_dim,
    "param_specs_embed_vocab_parallel": _case_embed,
    "param_specs_moe_expert_parallel_and_fallback": _case_moe_experts,
    "quantized_codes_tp_shard_output_dim": _case_quantized_output_dim,
    "quantized_odd_output_dim_replicates": _case_quantized_odd_output_dim,
    "quantized_moe_experts_shard_expert_dim": _case_quantized_experts,
    "cache_specs_batch_and_seq_sharding": _case_cache_specs,
}


@pytest.mark.parametrize("case", sorted(DIST_UNITS))
def test_dist_units_assertions_hold_in_both_packages(case):
    DIST_UNITS[case]()


def test_quantized_specs_to_shardings_roundtrip(gloo1):
    """The specs as DTensor placements: ``distribute_tensor`` under them
    gives each leaf whole on a one-rank mesh, and the placements name the
    sharded dims."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    _jcfg, tcfg = _cfg_pair()
    _jp, tp = _both({"wq": ("q", 16, 8, (2,), True), "embed": (64, 16)})
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    specs = param_specs(tcfg, tp, ShardCtx(AxisMesh((4, 2), ("data", "model"))))
    place = to_shardings(specs, mesh)
    assert place["wq"].codes == (Replicate(), Shard(1))
    assert place["embed"] == (Replicate(), Shard(0))
    dt = distribute_tensor(tp["embed"], mesh, place["embed"])
    assert torch.equal(dt.to_local(), tp["embed"])
    assert to_shardings(PSpec(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="lacks"):
        to_shardings(PSpec("pod", None), mesh)


# ---------------------------------------------------------------------------
# shard_tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_tree_cuts_every_ranks_slice(mesh):
    """Every coordinate's shard of every leaf is its slice: the shards of a
    leaf, put back in coordinate order, are the leaf (quantized codes along
    the output dim, expert stacks along the expert dim, fsdp dims over dp)."""
    _jcfg, tcfg, _jp, tp = _trees("deepseek-v2-lite-16b", True)
    sizes, names, dp = MESHES[mesh]
    ctx = ShardCtx(AxisMesh(sizes, names), dp_axes=dp, fsdp=True)
    specs = param_specs(tcfg, tp, ctx)
    grid = [dict(zip(names, c)) for c in np.ndindex(*sizes)]
    shards = [shard_tree(tp, specs, ctx, coords=c) for c in grid]
    leaves = [tree.tensors(s) for s in shards]
    full = tree.tensors(tp)
    assert len(full) == len(leaves[0])
    n_cut = 0
    for i, t in enumerate(full):
        for c, ls in zip(grid, leaves):
            want = t
            for d, entry in enumerate(_spec_of(specs, tp, t)):
                axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
                if not axes:
                    continue
                n = int(np.prod([dict(zip(names, sizes))[a] for a in axes]))
                idx = int(np.ravel_multi_index([c[a] for a in axes],
                                               [dict(zip(names, sizes))[a] for a in axes]))
                want = want.narrow(d, idx * (t.shape[d] // n), t.shape[d] // n)
                n_cut += 1
            assert torch.equal(ls[i], want)
    assert n_cut > 0
    with pytest.raises(ValueError, match="outside"):
        shard_tree(tp, specs, ctx, coords={"model": 2})


def _spec_of(specs, params, leaf):
    """The spec entry of ``leaf`` (found by identity) in ``params``."""
    found = []

    def walk(p, s):
        if isinstance(p, torch.Tensor):
            if p is leaf:
                found.append(s)
        elif isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, s):
                walk(a, b)
        elif isinstance(p, QuantizedLinear):
            for f in ("codes", "scale", "bias", "ascale"):
                walk(getattr(p, f), getattr(s, f))

    walk(params, specs)
    assert len(found) == 1
    return found[0]


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


def _inputs(n, case, dtype):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 96)) * 3.0).astype(np.float32)
    if case == "zeros":
        x[:] = 0
    elif case == "inf":
        x[n - 1, 5] = np.inf
    elif case == "nan":
        x[0, 7] = np.nan
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jx, tx


def _bits(a):
    """The f32 bits of a jax or torch array (bf16 widens exactly)."""
    f32 = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))
    return f32.view(np.uint32)


def _reference(jx):
    return jax.vmap(lambda v: jcompressed_psum(v, "i"), axis_name="i")(jx)


@pytest.mark.parametrize("case", ["normal", "zeros", "inf", "nan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_compressed_psum_steps_equal_reference(n, dtype, case):
    """n participants through the port's own steps — the abs-max, the codes,
    the int32 sum, the rescale — with the MAX and SUM all-reduces taken over
    the stacked participants: bit for bit the reference's output."""
    jx, tx = _inputs(n, case, dtype)
    want = _reference(jx)
    amax = torch.stack([collectives.abs_max(v) for v in tx]).max()
    codes = [collectives.int8_codes(v, amax) for v in tx]
    total = torch.stack([c.to(torch.int32) for c, _s in codes]).sum(0)
    got = collectives.rescale(total, codes[0][1], amax, tx.dtype)
    assert got.dtype == tx.dtype
    for i in range(n):
        np.testing.assert_array_equal(_bits(got), _bits(want[i]))
    if case == "normal" and dtype == "float32":
        # The reference's worst case: n * scale / 2 (+ rounding).
        exact = np.asarray(jx).sum(0)
        assert np.abs(got.numpy() - exact).max() <= n * float(amax) / 127.0 / 2 * 1.01


@pytest.mark.parametrize("case", ["normal", "zeros", "nan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_on_a_gloo_group_equals_reference(gloo1, dtype, case):
    jx, tx = _inputs(1, case, dtype)
    got = collectives.compressed_psum(tx[0].clone())
    np.testing.assert_array_equal(_bits(got), _bits(_reference(jx)[0]))


# ---------------------------------------------------------------------------
# mesh builders, pipeline_apply, sharded-call refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build,match", [
    (lambda: tmesh.make_smoke_mesh(3, device="cpu"), "even n >= 2"),
    (lambda: tmesh.make_smoke_mesh(0, device="cpu"), "even n >= 2"),
    (lambda: tmesh.make_stage_mesh(0, device="cpu"), "n_stages >= 1"),
])
def test_mesh_builders_refuse_bad_shapes(build, match):
    with pytest.raises(ValueError, match=match):
        build()


@pytest.mark.parametrize("build,need", [
    (lambda: tmesh.make_smoke_mesh(8, device="cpu"), 8),
    (lambda: tmesh.make_stage_mesh(4, device="cpu"), 4),
    (lambda: tmesh.make_production_mesh(device="cpu"), 256),
    (lambda: tmesh.make_production_mesh(multi_pod=True, device="cpu"), 512),
])
def test_mesh_builders_refuse_too_few_ranks(build, need):
    with pytest.raises(RuntimeError, match=f"need {need} devices.*torchrun --nproc-per-node {need}"):
        build()


def test_mesh_builders_in_a_one_rank_world(gloo1):
    with pytest.raises(RuntimeError, match="have 1 ranks"):
        tmesh.make_smoke_mesh(2, device="cpu")
    mesh = tmesh.make_stage_mesh(1, device="cpu")
    assert mesh.mesh_dim_names == ("stage",) and tuple(mesh.shape) == (1,)


def test_pipeline_apply_one_stage_and_its_refusals(gloo1):
    mesh = tmesh.make_stage_mesh(1, device="cpu")
    g = torch.Generator().manual_seed(0)
    ws = torch.randn((1, 8, 8), generator=g) * 0.3
    xs = torch.randn((5, 2, 8), generator=g)
    stage_fn = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    out = pipeline_apply(stage_fn, ws, xs, mesh)
    assert torch.equal(out, torch.stack([stage_fn(ws[0], x) for x in xs]))
    with pytest.raises(ValueError, match="mesh has no 'pipe' axis"):
        pipeline_apply(stage_fn, ws, xs, mesh, axis="pipe")
    with pytest.raises(ValueError, match=r"leading dims \[2\] != mesh stage size 1"):
        pipeline_apply(stage_fn, torch.zeros((2, 8, 8)), xs, mesh)


def test_sharded_call_on_a_one_rank_mesh(gloo1):
    """World 1, mesh (1, 1): the sharded forward is the unsharded one bit for
    bit (no collective is needed), with ``seq_shard`` too (a TP axis of 1
    cuts no cache: prefill and decode as well), and a forward with
    parameters that require grad runs: its gradients are the unsharded
    forward's bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype="float32")
    model = tmodel.build_model(cfg)
    params = model.init_quantized(LutLinearSpec(bw=1, ba=3, p=4, mode="lut"), device="cpu")
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    local = shard_tree(params, param_specs(cfg, params, ctx), ctx)
    with torch.no_grad():
        want, _ = model.forward(params, toks)
        got, _ = model.forward(local, toks, ctx=ctx)
    assert torch.equal(got, want)
    seq = dataclasses.replace(ctx, seq_shard=True)
    with torch.no_grad():
        assert torch.equal(model.forward(local, toks, ctx=seq)[0], want)
        outs = []
        for c in (None, seq):
            caches = model.init_cache(2, 16, torch.float32, device="cpu")
            tree_ = params if c is None else local
            lg, caches = model.prefill(tree_, toks, caches, ctx=c, max_seq=16)
            outs.append((lg, model.decode_step(tree_, toks[:, :1], caches, 8, ctx=c,
                                               max_seq=16)[0]))
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    dense = model.init(device="cpu")
    for t in tree.tensors(dense):
        t.requires_grad_(True)
    grads = [torch.autograd.grad(model.forward(dense, toks, ctx=c)[0].square().sum(),
                                 tree.tensors(dense)) for c in (ctx, None)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardCtx(AxisMesh((1, 1), ("data", "model"))).tp_group()
