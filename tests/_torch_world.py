"""One rank of the 4-rank gloo world that ``tests/test_torch_sharded.py``
spawns (torch and repro_torch only: no JAX in the ranks).

:func:`rank_main` initializes the rank over a ``FileStore``, builds a
``(data 2, model 2)`` mesh, runs every case and pickles its results to
``<out>/rank<r>.pkl`` (the test process asserts on them).  Each rank cuts
its own shards from the same seeded full tree (``shard_tree``) and also runs
the unsharded path in-process, so a sharded result is held against the
port's own unsharded one on the same inputs; the reference's expert-parallel
outputs come from ``<out>/ref_ep.pkl``, written by a JAX child first.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import traceback

import numpy as np

WORLD = 4
FORWARD_CASES = {
    # name: (arch, mode, fsdp, mesh, exact) — exact where only quantized
    # leaves and the embedding are sharded (gemma2 ties its head).
    "gemma2-2b/lut": ("gemma2-2b", "lut", False, "dm", True),
    "gemma2-2b/dense/fsdp": ("gemma2-2b", "dense", True, "dm", False),
    "deepseek-v2-lite-16b/lut": ("deepseek-v2-lite-16b", "lut", False, "dm", False),
    "zamba2-7b/lut": ("zamba2-7b", "lut", False, "dm", False),
    "rwkv6-3b/pallas/fsdp": ("rwkv6-3b", "pallas", True, "dm", False),
    "internvl2-1b/lut": ("internvl2-1b", "lut", False, "dm", False),
    "whisper-large-v3/lut": ("whisper-large-v3", "lut", False, "dm", False),
    "stablelm-12b/lut/pod": ("stablelm-12b", "lut", False, "pdm", False),
}
SERVE_DRIVERS = ("scan", "loop", "chunked")


def _spec(mode):
    from repro_torch.core import LutLinearSpec

    return LutLinearSpec(bw=1, ba=3, p=4, mode="lut") if mode == "lut" else \
        LutLinearSpec(bw=4, ba=4, mode=mode)


def _cfg(arch):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.moe is not None:    # dropless: the EP capacity counts the dp-local tokens
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def forward_case(name, meshes):
    import torch

    from repro_torch import dist as rd
    from repro_torch.models.model import Model

    arch, mode, fsdp, mesh, exact = FORWARD_CASES[name]
    cfg = _cfg(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu") if mode == "dense" else \
        model.init_quantized(_spec(mode), 0, device="cpu")
    dp_axes = ("pod", "data") if mesh == "pdm" else ("data",)
    ctx = rd.ShardCtx(meshes[mesh], dp_axes=dp_axes, fsdp=fsdp)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    kw = {}
    if cfg.frontend is not None:
        kw["prefix_embeds"] = torch.randn((4, cfg.frontend_seq, cfg.frontend_dim), generator=gen)
    rows = rd.runtime.rows_of(4, ctx)
    with torch.no_grad():
        want, _, aux_want = model.forward(params, toks, return_aux=True, **kw)
        local = rd.shard_tree(params, rd.param_specs(cfg, params, ctx), ctx)
        got, _, aux = model.forward(local, toks[rows], ctx=ctx, return_aux=True,
                                    **{k: v[rows] for k, v in kw.items()})
    return {"err": _rel(got, want[rows]), "equal": bool(torch.equal(got, want[rows])),
            "exact": exact, "aux_err": abs(float(aux) - float(aux_want)),
            "shape": tuple(got.shape)}


def global_amax_case(meshes):
    """The uncalibrated lut scale under dp: this rank's rows alone give
    another abs-max than the whole batch; ``global_ascale`` gives the whole
    batch's scale."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.core.quantize import quantize_activation
    from repro_torch.dist.runtime import ShardedRun
    from repro_torch.models.model import Model

    cfg = _cfg("gemma2-2b")
    params = Model(cfg).init_quantized(_spec("lut"), 0, device="cpu")
    ctx = rd.ShardCtx(meshes["dm"])
    local = rd.shard_tree(params, rd.param_specs(cfg, params, ctx), ctx)
    x = torch.randn((4, 8, cfg.d_model), generator=torch.Generator().manual_seed(2))
    x[0] *= 3.0                           # dp rank 0's rows hold the batch's max
    rows = rd.runtime.rows_of(4, ctx)
    q = local["segments"][0]["s0_L"]["attn"]["wq"]
    aspec = q.spec.aspec()
    _, whole = quantize_activation(x.reshape(-1, cfg.d_model).T, aspec)
    _, mine = quantize_activation(x[rows].reshape(-1, cfg.d_model).T, aspec)
    run = ShardedRun(cfg, local, ctx)
    got = run.global_ascale(q, x[rows])
    return {"global_equal": bool(torch.equal(got, whole)),
            "local_differs": bool(not torch.equal(mine, whole))}


def ep_case(out_dir, meshes):
    """EP moe_apply on this rank's experts and dp rows against the
    reference's moe_apply(ctx) on a (2, 2) mesh."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig, MoEConfig

    with open(os.path.join(out_dir, "ref_ep.pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=2, d_ff=32, vocab_size=64, dtype="float32",
                      moe=MoEConfig(**ref["moe"]))
    p = params_from_numpy(ref["params"], device="cpu")
    ctx = rd.ShardCtx(meshes["dm"])
    # The expert stacks cut by the specs (E on the TP axis); the router and
    # the shared FFN replicated, as the reference's test places them.
    local = {**p, **rd.shard_tree({"moe": p}, rd.param_specs(cfg, {"moe": p}, ctx), ctx)["moe"],
             "router": p["router"], "shared": p["shared"]}
    rows = rd.runtime.rows_of(4, ctx)
    x = torch.from_numpy(ref["x"][rows])
    with torch.no_grad():
        y, aux = moe.moe_apply(local, x, cfg, ctx)
        unsharded, _ = moe.moe_apply(p, torch.from_numpy(ref["x"]), cfg)
    want = torch.from_numpy(ref["y"][rows])
    return {"err": _rel(y, want), "equal_reference": bool(torch.equal(y, want)),
            "equal_unsharded": bool(torch.equal(y, unsharded[rows])),
            "aux_err": abs(float(aux) - float(ref["aux"])),
            "local_experts": int(local["w_gate"].shape[0])}


def pipeline_case():
    """``pipeline_apply`` at 4 stages against the stages applied one after
    another to each microbatch."""
    import torch

    from repro_torch.dist import pipeline_apply
    from repro_torch.launch.mesh import make_stage_mesh

    mesh = make_stage_mesh(WORLD, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ws = torch.randn((WORLD, 8, 8), generator=gen) * 0.3
    xs = torch.randn((6, 2, 8), generator=gen)
    stage_fn = lambda w, x: torch.tanh(x @ w)  # noqa: E731
    out = pipeline_apply(stage_fn, ws, xs, mesh)
    want = []
    for x in xs:
        for i in range(WORLD):
            x = stage_fn(ws[i], x)
        want.append(x)
    return {"equal": bool(torch.equal(out, torch.stack(want))), "shape": tuple(out.shape)}


def psum_case():
    """compressed_psum over the 4 ranks (the test holds it to the reference
    under vmap at n = 4)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import compressed_psum

    rng = np.random.default_rng(4)
    xs = (rng.standard_normal((WORLD, 64)) * 2.0).astype(np.float32)
    mine = torch.from_numpy(xs[dist.get_rank()].copy())
    return {"inputs": xs, "f32": compressed_psum(mine.clone()).numpy(),
            "bf16": compressed_psum(mine.to(torch.bfloat16)).float().numpy()}


def serve_case(driver, meshes):
    """ServeEngine(ctx=) against the unsharded engine on the same requests."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.core.calibrate import calibrate_tree
    from repro_torch.models.model import Model, prepare_params
    from repro_torch.serve.serving import Request, ServeEngine

    cfg = _cfg("gemma2-2b")
    model = Model(cfg)
    raw = model.init_quantized(_spec("lut"), 0, device="cpu")
    rng = np.random.default_rng(3)
    cal = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        raw = calibrate_tree(lambda probed: model.forward(probed, cal)[0], raw)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for n, m in ((3, 5), (9, 4), (6, 6), (4, 3), (7, 5),
                                                    (2, 4))]
    ctx = rd.ShardCtx(meshes["dm"])
    local = prepare_params(rd.shard_tree(raw, rd.param_specs(cfg, raw, ctx), ctx))
    out = {}
    for name, tree_, c in (("ref", prepare_params(raw), None), ("sharded", local, ctx)):
        eng = ServeEngine(model, tree_, batch=4, max_seq=32, decode=driver, ctx=c,
                          device="cpu")
        waves = []
        eng.on_wave = waves.append
        with torch.no_grad():
            toks = eng.generate(reqs)
        out[name] = {"tokens": toks, "admissions": list(eng.admissions),
                     "host_syncs": eng.host_syncs, "waves": len(waves),
                     "buckets": dict(eng.bucket_counts)}
    return out


def refusals_case(meshes):
    """What a mesh still refuses: training, and seq_shard execution."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = _cfg("gemma2-2b")
    model = Model(cfg)
    ctx = rd.ShardCtx(meshes["dm"])
    msgs = {}
    for what, fn in (
        ("train_step", lambda: ts.make_train_step(model, opt.AdamWConfig(), ctx=ctx)),
        ("seq_shard", lambda: model.forward(
            model.init(0, device="cpu"), torch.zeros((2, 4), dtype=torch.long),
            ctx=dataclasses.replace(ctx, seq_shard=True))),
    ):
        try:
            fn()
            msgs[what] = None
        except NotImplementedError as e:
            msgs[what] = str(e)
    return msgs


def rank_main(rank: int, out_dir: str) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    res: dict = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
                                rank=rank, world_size=WORLD)
        meshes = {"dm": init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
                  "pdm": init_device_mesh("cpu", (2, 1, 2),
                                          mesh_dim_names=("pod", "data", "model"))}
        res["forward"] = {name: forward_case(name, meshes) for name in FORWARD_CASES}
        res["global_amax"] = global_amax_case(meshes)
        res["ep"] = ep_case(out_dir, meshes)
        res["pipeline"] = pipeline_case()
        res["psum"] = psum_case()
        res["serve"] = {d: serve_case(d, meshes) for d in SERVE_DRIVERS}
        res["refusals"] = refusals_case(meshes)
        dist.destroy_process_group()
    except Exception:                       # the test reads the traceback
        res["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
