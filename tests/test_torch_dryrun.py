"""Port parity: the device-less dry-run (``repro_torch.launch.dryrun``) and its
roofline (``repro_torch.launch.roofline``) against the reference's
``repro.launch.dryrun`` and ``benchmarks/roofline.py`` (CPU, one process; the
reference's side is computed from shapes, nothing is compiled).

* (a) ``SHAPES``, the variants, ``skip_reason``, ``input_specs`` (shapes and
  dtypes), ``depth_knobs`` and ``make_ctx`` equal the reference's for all ten
  configs x four shapes;
* (b) the ring factors give ``tests/test_system.py``'s four numbers and agree
  with the reference's ``parse_collective_bytes`` at several group sizes;
* (c) a rank's ``argument_size_in_bytes`` on the ``(16, 16)`` mesh at
  ``decode_32k`` equals the sum of the reference's per-shard bytes
  (``param_specs`` / ``cache_specs`` on ``eval_shape`` trees,
  ``NamedSharding(AbstractMesh, spec).shard_shape``);
* (d) ``model_flops_per_chip`` equals the reference's for every config and
  shape;
* (e) on smoke configs the full-depth trace equals the depth-differenced
  ``calibrated`` count, and the sequence-scaled recurrences equal a full
  trace at a short length, exactly;
* (f) a decode step's matmul FLOPs on a ``(2, 2)`` fake mesh equal a count
  written here from the config's shapes;
* (g) the fake world is torn down after an error, and ``run_cell`` refuses
  to run where a default process group exists;
* an artifact written by ``run_cell`` and the roofline read back from it.
"""

import dataclasses
import functools
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist.sharding import AxisMesh, ShardCtx  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ("ring_window_cache", "mla_prefill_headshard", "kv_cache_int8", "attend_bf16",
         "gqa_prefill_headshard")


@functools.lru_cache(maxsize=1)
def _ref_roofline():
    """``benchmarks/roofline.py`` loaded from its file (``benchmarks`` is not
    a package on the test path)."""
    spec = importlib.util.spec_from_file_location("_ref_roofline",
                                                  ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- (a) -----------------------------------------------------------------------


def test_shapes_quant_spec_and_variants_equal_reference():
    assert dryrun.SHAPES == jdry.SHAPES
    for f in ("bw", "ba", "p", "mode", "w_kind", "a_kind"):
        assert getattr(dryrun.QUANT_SPEC, f) == getattr(jdry.QUANT_SPEC, f)
    assert dryrun.BW_VARIANTS == jdry.BW_VARIANTS
    assert list(dryrun.VARIANTS) == list(jdry.VARIANTS)
    cfg, jcfg = get_config("gemma2-2b"), jget_config("gemma2-2b")
    for name in dryrun.VARIANTS:
        got, want = dryrun.VARIANTS[name](cfg), jdry.VARIANTS[name](jcfg)
        assert {f: getattr(got, f) for f in FLAGS} == {f: getattr(want, f) for f in FLAGS}, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skips_input_specs_knobs_and_ctx_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in dryrun.SHAPES:
        assert dryrun.skip_reason(cfg, shape) == jdry.skip_reason(jcfg, shape)
        got, want = dryrun.input_specs(cfg, shape), jdry.input_specs(jcfg, shape)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (shape, k)
            assert str(got[k].dtype) == f"torch.{np.dtype(want[k].dtype).name}", (shape, k)
    assert [(k.name, k.n_real) for k in dryrun.depth_knobs(cfg)] == \
        [(k.name, k.n_real) for k in jdry.depth_knobs(jcfg)]
    for ks in ({}, {"stack": 3}, {"encoder": 3}):
        got, want = dryrun.with_knobs(cfg, ks), jdry.with_knobs(jcfg, ks)
        assert (got.n_layers, got.encoder_layers) == (want.n_layers, want.encoder_layers)
    for sizes, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        for shape, sh in dryrun.SHAPES.items():
            got = dryrun.make_ctx(AxisMesh(sizes, names), shape, sh["kind"])
            want = jdry.make_ctx(AbstractMesh(sizes, names), shape, sh["kind"])
            assert (got.dp_axes, got.tp_axis, got.fsdp, got.seq_shard) == \
                (want.dp_axes, want.tp_axis, want.fsdp, want.seq_shard)
            assert (got.dp_size(), got.tp_size()) == (want.dp_size(), want.tp_size())


# --- (b) -----------------------------------------------------------------------


def test_ring_factors_give_the_reference_numbers():
    text = """
  %ag = f32[8,128]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={1}
  %ar = bf16[64]{0} all-reduce(%y), replica_groups=[2,8]<=[16]
  %rs = f32[4,32]{1,0} reduce-scatter(%z), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[16]{0} collective-permute(%w), source_target_pairs={{0,1}}
"""
    got = {"all-gather": dryrun.ring_bytes("all-gather", 8 * 128 * 4, 4),
           "all-reduce": dryrun.ring_bytes("all-reduce", 64 * 2, 8),
           "reduce-scatter": dryrun.ring_bytes("reduce-scatter", 4 * 32 * 4, 2),
           "collective-permute": dryrun.ring_bytes("collective-permute", 16 * 4, 1)}
    assert got["all-gather"] == 8 * 128 * 4 * (3 / 4)
    assert got["all-reduce"] == 64 * 2 * 2 * (7 / 8)
    assert got["reduce-scatter"] == 4 * 32 * 4 * 1
    assert got["collective-permute"] == 16 * 4
    ref = jdry.parse_collective_bytes(text)
    assert {k: ref[k] for k in got} == got
    assert ref["all-to-all"] == 0.0


@pytest.mark.parametrize("g", [1, 2, 16, 256])
def test_ring_factors_agree_with_reference_parse(g):
    ops = {"all-gather": "all-gather", "all-reduce": "all-reduce",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all"}
    for kind, hlo in ops.items():
        line = f"  %c = bf16[96,40]{{1,0}} {hlo}(%x), replica_groups=[{512 // g},{g}]<=[512]"
        want = jdry.parse_collective_bytes(line)[kind]
        assert dryrun.ring_bytes(kind, 96 * 40 * 2, g) == want, (kind, g)


# --- (c) -----------------------------------------------------------------------


def _ref_shard_bytes(arch: str) -> int:
    """The reference's per-shard bytes of a rank's decode_32k arguments on the
    (16, 16) mesh: params, caches, tokens and ``pos`` — with the Mamba2 state
    (``ssd``, ``conv``) counted in f32, as the port keeps it whatever the
    cache dtype (``repro_torch.models.ssm.init_ssm_state``; the reference
    allocates it in the cache dtype and its ``ssm_apply`` returns it in f32)."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = jget_config(arch)
    ctx = jdry.make_ctx(mesh, "decode_32k", "decode")
    sh = jdry.SHAPES["decode_32k"]
    state = jdry._abstract_state(cfg, "decode", True)
    caches = jax.eval_shape(
        lambda: jbuild_model(cfg).init_cache(sh["batch"], sh["seq"], dtype=jnp.bfloat16))
    ins = jdry.input_specs(cfg, "decode_32k")
    tok_spec = P(ctx.dp(), None) if sh["batch"] % ctx.dp_size() == 0 else P()
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    pspecs = jax.tree.leaves(jshd.param_specs(cfg, state, ctx), is_leaf=is_spec)
    cspecs = jax.tree.leaves(jshd.cache_specs(cfg, caches, ctx), is_leaf=is_spec)
    pairs = [(a, spec, a.dtype.itemsize) for a, spec in zip(jax.tree.leaves(state), pspecs)]
    for (path, a), spec in zip(jax.tree_util.tree_leaves_with_path(caches), cspecs):
        ssm_state = path[-1].key in ("ssd", "conv")
        pairs.append((a, spec, 4 if ssm_state else a.dtype.itemsize))
    pairs += [(ins["tokens"], tok_spec, 4), (ins["pos"], P(), 4)]
    return sum(math.prod(NamedSharding(mesh, spec).shard_shape(a.shape)) * size
               for a, spec, size in pairs)


@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-v2-lite-16b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_rank_argument_bytes_equal_reference_shards(arch):
    want = _ref_shard_bytes(arch)
    with dryrun.fake_world(256, 0):
        mesh = make_production_mesh(device="cpu")
        cell = dryrun.build_cell(get_config(arch), "decode", 128, 32768, device="meta",
                                 ctx=dryrun.make_ctx(mesh, "decode_32k", "decode"))
        got = dryrun.tensor_bytes(*cell.args())
    # The port's decode offset is a host int; the reference's pos a 4-byte int32.
    assert cell.pos == 32767
    assert got + 4 == want


def test_quantized_leaf_on_meta_has_the_computed_leafs_shapes():
    from repro_torch.core import LutLinearSpec, quantize_linear

    for bw in (1, 2, 4, 8):
        for k in (13, 64):
            for dtype in (torch.float32, torch.bfloat16):
                w = torch.randn(k, 6, dtype=dtype)
                spec = LutLinearSpec(bw=bw, ba=4)
                real = quantize_linear(w, spec, bias=torch.zeros(6))
                meta = quantize_linear(w.to("meta"), spec, bias=torch.zeros(6, device="meta"))
                for f in ("codes", "scale", "bias"):
                    a, b = getattr(real, f), getattr(meta, f)
                    assert (b.device.type, tuple(b.shape), b.dtype) == \
                        ("meta", tuple(a.shape), a.dtype), (bw, k, dtype, f)
                assert (meta.k, meta.spec, meta.ascale) == (real.k, real.spec, real.ascale)


# --- (d) -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_per_chip_equal_reference(arch):
    ref = _ref_roofline()
    for shape in dryrun.SHAPES:
        assert roofline.model_flops_per_chip(arch, shape) == \
            ref.model_flops_per_chip(arch, shape), shape


# --- (e) -----------------------------------------------------------------------


def _smoke(arch: str, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


@pytest.fixture
def mesh22():
    """A ``(data 2, model 2)`` mesh over a fake world of 4 (rank 0)."""
    with dryrun.fake_world(4, 0):
        yield make_smoke_mesh(4, device="cpu")


def _ctx(mesh, kind):
    return ShardCtx(mesh, dp_axes=("data",), tp_axis="model", fsdp=(kind == "train"))


FIELDS = ("flops", "bytes_accessed", "collective_bytes")


@pytest.mark.parametrize("cfg_kw, kind, batch, seq", [
    (("stablelm-12b", dict(n_layers=5)), "decode", 4, 64),
    (("stablelm-12b", dict(n_layers=5)), "train", 4, 32),
    (("whisper-large-v3", dict(n_layers=4, encoder_layers=5)), "prefill", 4, 32),
    (("zamba2-7b", dict(n_layers=13)), "decode", 4, 64),
    (("deepseek-v2-lite-16b", dict(n_layers=6)), "decode", 4, 64),
], ids=["stablelm-decode", "stablelm-train", "whisper-prefill", "zamba2-decode",
        "deepseek-decode"])
def test_full_depth_trace_equals_calibrated(mesh22, cfg_kw, kind, batch, seq):
    arch, kw = cfg_kw
    cfg = _smoke(arch, **kw)
    ctx = _ctx(mesh22, kind)
    full = dryrun.count_step(dryrun.build_cell(cfg, kind, batch, seq, ctx=ctx))
    cal = dryrun.calibrated_costs(cfg, kind, batch, seq, ctx=ctx, full=full)
    assert all(k.n_real > 3 for k in dryrun.depth_knobs(cfg))
    assert cal["calibrated_equals_full"] == {k: True for k in FIELDS}
    assert full["flops"] > 0 and sum(full["collective_bytes"].values()) > 0


@pytest.mark.parametrize("arch, kind", [("zamba2-7b", "prefill"), ("zamba2-7b", "train"),
                                        ("rwkv6-3b", "prefill"), ("rwkv6-3b", "train")])
def test_scaled_recurrence_equals_full_trace(mesh22, arch, kind):
    cfg = get_config(arch, smoke=True)
    ctx = _ctx(mesh22, kind)
    seq = 48                                   # > REC_SHORT, 48 - 8 a multiple of 8
    full = dryrun.count_step(dryrun.build_cell(cfg, kind, 4, seq, ctx=ctx),
                             scale_recurrences=False)
    scaled = dryrun.count_step(dryrun.build_cell(cfg, kind, 4, seq, ctx=ctx))
    assert (full["recurrence_scaled"], scaled["recurrence_scaled"]) == (False, True)
    assert {k: scaled[k] for k in FIELDS} == {k: full[k] for k in FIELDS}
    assert scaled["argument_size_in_bytes"] == full["argument_size_in_bytes"]
    assert scaled["output_size_in_bytes"] == full["output_size_in_bytes"]
    assert full["ops_counted"] > 4 * seq * cfg.n_layers


# --- (f) -----------------------------------------------------------------------


def test_decode_matmul_flops_equal_the_count_from_shapes(mesh22):
    cfg = get_config("stablelm-12b", smoke=True)
    batch, seq, tp = 4, 64, 2
    got = dryrun.count_step(dryrun.build_cell(cfg, "decode", batch, seq,
                                              ctx=_ctx(mesh22, "decode")))
    b = batch // 2                              # the rank's dp rows
    d, h, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                           cfg.vocab_size)
    # (K, F) of each quantized projection; the output dim F is cut over TP.
    proj = [(d, h * hd), (d, hkv * hd), (d, hkv * hd), (h * hd, d), (d, f), (d, f), (f, d)]
    per_layer = sum(2 * b * k * (n // tp if n % tp == 0 else n) for k, n in proj)
    # Full-cache attention: one block of INVARIANT_ROWS query rows, all heads, T keys.
    per_layer += 2 * 2 * b * h * 32 * hd * seq
    head = 2 * b * d * v // tp                  # the column-parallel LM head
    assert cfg.gated_ffn and not cfg.tie_embeddings
    assert got["flops"] == cfg.n_layers * per_layer + head
    # every projection and the head all-gathered over model, nothing over data
    assert set(got["collective_bytes_by_axis"]) == {"model"}


@pytest.mark.parametrize("arch, kind, rows, seq", [
    ("stablelm-12b", "decode", 4, 64), ("stablelm-12b", "prefill", 2, 40),
    ("stablelm-12b", "train", 2, 32), ("zamba2-7b", "prefill", 2, 40),
    ("rwkv6-3b", "train", 2, 40),
])
def test_meta_count_equals_the_step_run_on_the_cpu(arch, kind, rows, seq):
    """The count on ``meta`` against the same step run on real tensors (CPU,
    a world of one): the argument and output bytes, and the matmul FLOPs that
    ``FlopCounterMode`` counts around it — as phase 25b holds it on the card
    (sequence-scaled recurrences included: 40 positions)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(arch, smoke=True)
    counted = dryrun.count_step(dryrun.build_cell(cfg, kind, rows, seq, device="meta"))
    cell = dryrun.build_cell(cfg, kind, rows, seq, device="cpu")
    assert dryrun.tensor_bytes(*cell.args()) == counted["argument_size_in_bytes"]
    with FlopCounterMode(display=False) as fc:
        out = cell.step()
    assert fc.get_total_flops() == counted["flops"]
    assert dryrun.tensor_bytes(out) == counted["output_size_in_bytes"]
    assert counted["recurrence_scaled"] == (arch != "stablelm-12b")


# --- (g) -----------------------------------------------------------------------


def test_fake_world_is_torn_down_after_an_error():
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_world(8, 3):
            assert dist.is_initialized() and dist.get_rank() == 3
            1 / 0
    assert not dist.is_initialized()


def test_run_cell_refuses_when_a_default_group_exists(tmp_path):
    with dryrun.fake_world(4, 0):
        with pytest.raises(RuntimeError, match="default process group"):
            dryrun.run_cell("rwkv6-3b", "decode_32k", "single", do_cost=False,
                            results_dir=str(tmp_path))
        with pytest.raises(RuntimeError, match="default process group"):
            with dryrun.fake_world(4, 0):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())


# --- artifacts and the roofline ---------------------------------------------------


def test_run_cell_artifacts_and_roofline(tmp_path):
    skip = dryrun.run_cell("stablelm-12b", "long_500k", "single", do_cost=False,
                           results_dir=str(tmp_path))
    rec = dryrun.run_cell("rwkv6-3b", "decode_32k", "single", do_cost=False,
                          results_dir=str(tmp_path))
    assert not dist.is_initialized()
    assert skip["status"] == "skipped"
    assert skip["skip_reason"] == jdry.skip_reason(jget_config("stablelm-12b"), "long_500k")
    assert rec["status"] == "traced", rec.get("traceback")
    path = tmp_path / "single" / "rwkv6-3b__decode_32k.json"
    saved = json.loads(path.read_text())
    assert saved["full_analysis"] == rec["full_analysis"]
    full = saved["full_analysis"]
    assert (saved["world_size"], saved["mesh_shape"], saved["mesh_axes"]) == \
        (256, [16, 16], ["data", "model"])
    assert saved["last_rank"]["rank"] == 255 and saved["last_rank"]["coords"] == [15, 15]
    assert saved["argument_bytes_differ"] is False
    assert saved["recurrence_scaled"] is False
    assert (full["flops_counts"], full["bytes_counts"]) == ("matmul", "unfused")
    assert full["flops"] > 0 and full["temp_size_in_bytes"] > 0
    assert full["collective_group_sizes"] == {"model": 16}
    terms = roofline.cell_terms(saved)
    assert terms["collective_links"] == {"model": "network"}
    hw = roofline.CHIP
    assert terms["t_collective_s"] == \
        full["collective_bytes_by_axis"]["model"] / hw.network_bandwidth
    assert terms["t_memory_s"] == full["bytes_accessed"] / hw.hbm_bandwidth
    table = roofline.markdown_table(str(tmp_path))
    assert roofline.LABEL in table and "| rwkv6-3b | decode_32k | W4A4 |" in table
    assert "Skipped (full-attention decoder): stablelm-12b long_500k." in table
    names = [r[0] for r in roofline.rows(str(tmp_path))]
    assert names == ["roofline/rwkv6-3b/decode_32k", "roofline/stablelm-12b/long_500k"]


def test_axis_links_follow_the_node_boundaries():
    card = roofline.CHIP
    assert roofline.axis_link("model", (16, 16), ("data", "model"))[0] == "network"
    assert roofline.axis_link("data", (16, 16), ("data", "model"))[0] == "network"
    assert roofline.axis_link("pod+data", (2, 16, 16), ("pod", "data", "model"))[0] == \
        "network"
    assert roofline.axis_link("model", (32, 8), ("data", "model")) == \
        ("nvlink", card.nvlink_bandwidth)
    assert roofline.axis_link("model", (16, 4), ("data", "model"))[0] == "nvlink"
    assert roofline.axis_link("data", (2, 4), ("data", "model"))[0] == "nvlink"
    assert roofline.axis_link("data", (4, 4), ("data", "model"))[0] == "network"
