"""One rank of the 4-rank gloo world that ``tests/test_torch_sharded.py``
spawns (torch and repro_torch only: no JAX in the ranks).

:func:`rank_main` initializes the rank over a ``FileStore``, builds a
``(data 2, model 2)`` mesh, runs every case and pickles its results to
``<out>/rank<r>.pkl`` (the test process asserts on them).  Each rank cuts
its own shards from the same seeded full tree (``shard_tree``) and also runs
the unsharded path in-process, so a sharded result is held against the
port's own unsharded one on the same inputs; the reference's expert-parallel
outputs, its chatglm3-6b smoke step and its ``ckpt.save`` of the stepped
train state on a ``(2, 2)`` mesh come from ``<out>/ref_ep.pkl`` and
``<out>/ref_ckpt``, written by a JAX child first.  The same child then runs
the reference's jitted sequence-sharded steps (:data:`SEQ_CASES`) while the
world runs, on the inputs every rank builds too (:func:`seq_inputs`: the
port's seeded parameters, numpy-seeded tokens); the test holds the ranks'
logits to those.
"""

from __future__ import annotations

import contextlib
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
TRAIN_CASES = {
    # name: (arch, accum_steps); FSDP + TP on (data 2, model 2), f32
    "chatglm3-6b": ("chatglm3-6b", 1),              # the reference's case
    "chatglm3-6b/accum2": ("chatglm3-6b", 2),
    "gemma2-2b": ("gemma2-2b", 1),                  # tied vocab-parallel head
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", 1),   # EP, MLA, aux loss (dropless)
    "internvl2-1b": ("internvl2-1b", 1),            # prefix_embeds dp-local
    "rwkv6-3b": ("rwkv6-3b", 1),                    # a recurrent family
}
ELASTIC_MESHES = ("dm", "d4", "m4")                 # (2, 2), (4, 1), (1, 4)
REF_STEP = 5                                        # the step the reference saved
TOL_GRAD = 1e-5       # a rank's gradient shards vs the unsharded step's, x the leaf's max |g|
SPREAD = 2.0          # ... or x the unsharded step's own move under TP's reordering where
                      # that is larger (rwkv6-3b's time_mix/u: ~3.5e-5); two reorderings
                      # (dp's and TP's) against the one measured
SEQ_CASES = {
    # name: (arch, config overrides, max_seq, prompt length) — f32 smoke
    # configs whose caches cache_specs cuts along the sequence at tp 4 and 2
    # (dim 2 >= 1024): each cache branch the port runs sharded
    "stablelm-12b": ("stablelm-12b", {}, 1024, 600),                      # full K/V
    "stablelm-12b/int8": ("stablelm-12b", {"kv_cache_int8": True}, 1024, 600),
    "gemma2-2b/ring": ("gemma2-2b", {"ring_window_cache": True, "window": 1024}, 2048,
                       1100),                                             # ring + full
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}, 1024, 600),      # MLA latents
    "zamba2-7b": ("zamba2-7b", {}, 1024, 600),                            # the shared block
    "whisper-large-v3": ("whisper-large-v3", {"frontend_seq": 1024}, 1024, 600),   # cross
    "rwkv6-3b": ("rwkv6-3b", {"d_model": 1024, "n_layers": 1}, 64, 40),   # x_prev_* (trap:
                                                                          # a feature dim)
}
SEQ_MESHES = ("m4", "dm")             # (1, 4): tp 4; (2, 2): tp 2 over dp 2
SEQ_STEPS = 3                         # teacher-forced decode steps after the prefill
SEQ_PAD = (0, 37)                     # the rows' left pads
SEQ_SERVE = ((3, 3), (300, 2), (9, 3))   # (prompt, max_new): one prompt over a tp-4
                                         # shard of 256 positions
SEQ_SERVE_MESHES = {"scan": ("m4", "dm"), "loop": ("dm",), "chunked": ("m4",)}
LAUNCH_ARGV = ["--arch", "chatglm3-6b", "--steps", "4", "--batch", "4", "--seq", "16",
               "--lr", "1e-3", "--ckpt-every", "2", "--device", "cpu"]


def _spec(mode):
    from repro_torch.core import LutLinearSpec

    return LutLinearSpec(bw=1, ba=3, p=4, mode="lut") if mode == "lut" else \
        LutLinearSpec(bw=4, ba=4, mode=mode)


def _cfg(arch, get_config=None, **over):
    """``arch``'s f32 smoke config (dropless where it has MoE layers), with
    ``over``; ``get_config`` is the reference's in the JAX child."""
    if get_config is None:
        from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **over)
    if cfg.moe is not None:    # dropless: the EP capacity counts the dp-local tokens
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def seq_inputs(name) -> dict:
    """Case ``name``'s inputs, the same in every process: the port's
    parameters of its config from seed 0 (CPU generator) as a numpy tree,
    numpy-seeded prompts of the case's length, teacher-forced decode tokens,
    the pads and, on an enc-dec config, frames."""
    from repro_torch.models.model import Model

    arch, over, _max_seq, s = SEQ_CASES[name]
    cfg = _cfg(arch, **over)
    rng = np.random.default_rng(7)
    b = len(SEQ_PAD)
    return {"params": _numpy_tree(Model(cfg).init(0, device="cpu")),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "steps": rng.integers(0, cfg.vocab_size, (SEQ_STEPS, b, 1)).astype(np.int32),
            "pad": np.asarray(SEQ_PAD, np.int32),
            "frames": rng.standard_normal((b, cfg.frontend_seq, cfg.frontend_dim))
            .astype(np.float32) if cfg.is_encdec else None}


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy_tree(v) for v in t]
    return t.numpy()


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


def seq_shard_steps_case(meshes):
    """Steps without a cache under ``seq_shard``: a forward and a train step
    on (2, 2) give what they give without it (nothing is sequence-sharded
    there), bit for bit; and a call over caches refuses a missing or wrong
    ``max_seq`` (it fixes which leaves were cut)."""
    import torch

    from repro_torch import dist as rd
    from repro_torch import tree
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = _cfg("gemma2-2b")
    model = Model(cfg)
    ctx = rd.ShardCtx(meshes["dm"])
    seq = dataclasses.replace(ctx, seq_shard=True)
    state = ts.init_train_state(model, 0, device="cpu")
    local = rd.shard_tree(state, ts.train_state_specs(cfg, ctx), ctx)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 5)))
    steps = [ts.make_train_step(model, opt.AdamWConfig(), ctx=c)(local, {"tokens": toks})
             for c in (ctx, seq)]
    whole = model.init(0, device="cpu")
    params = rd.shard_tree(whole, rd.param_specs(cfg, whole, ctx), ctx)
    with torch.no_grad():
        fwd = [model.forward(params, toks, ctx=c)[0] for c in (ctx, seq)]
    (a, ma), (b, mb) = steps
    msgs = {}
    caches = rd.shard_tree(model.init_cache(2, 2048, torch.float32, device="cpu"),
                           rd.cache_specs(cfg, model.init_cache(2, 2048, device="meta"), seq),
                           seq)
    for what, max_seq in (("no_max_seq", None), ("other_max_seq", 1024)):
        try:
            model.prefill(params, toks[rd.runtime.rows_of(2, seq)], caches, ctx=seq,
                          max_seq=max_seq)
            msgs[what] = None
        except ValueError as e:
            msgs[what] = str(e)
    return {"forward_equal": bool(torch.equal(*fwd)),
            "step_equal": float(ma["loss"]) == float(mb["loss"]) and all(
                torch.equal(x, y) for x, y in zip(tree.tensors(a.params), tree.tensors(b.params))),
            **msgs}


def seq_case(name, meshes, inp):
    """A sequence-sharded case: the prefill and ``SEQ_STEPS`` teacher-forced
    decode steps (``[B]`` write offsets) of the reference's parameters on the
    rank's shards, on (1, 4) and (2, 2) with ``seq_shard``, and the same
    calls unsharded on the whole batch; the test holds the logits to each
    other and to the reference's jitted steps."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.convert import params_from_numpy
    from repro_torch import tree
    from repro_torch.models.model import Model

    arch, over, max_seq, s = SEQ_CASES[name]
    cfg = _cfg(arch, **over)
    model = Model(cfg)
    params = params_from_numpy(inp["params"], device="cpu")
    toks, steps, pad = (torch.from_numpy(inp[k]) for k in ("tokens", "steps", "pad"))
    frames = None if inp["frames"] is None else torch.from_numpy(inp["frames"])
    b = toks.shape[0]

    def run(tree_, caches, rows, ctx):
        kw = {} if frames is None else {"prefix_embeds": frames[rows]}
        lg, caches = model.prefill(tree_, toks[rows], caches, pad_len=pad[rows], ctx=ctx,
                                   max_seq=max_seq, **kw)
        out = [lg]
        for t in range(SEQ_STEPS):
            pos = torch.full((rows.stop - rows.start,), s + t, dtype=torch.int32)
            lg, caches = model.decode_step(tree_, steps[t][rows], caches, pos, ctx=ctx,
                                           pad_len=pad[rows], max_seq=max_seq)
            out.append(lg)
        return [o.numpy() for o in out]

    with torch.no_grad():
        res = {"unsharded": run(params, model.init_cache(b, max_seq, torch.float32,
                                                         device="cpu"), slice(0, b), None)}
        for m in SEQ_MESHES:
            ctx = rd.ShardCtx(meshes[m], seq_shard=True)
            whole = model.init_cache(b, max_seq, torch.float32, device="cpu")
            caches = rd.shard_tree(whole, rd.cache_specs(cfg, whole, ctx), ctx)
            rows = rd.runtime.rows_of(b, ctx)
            local = rd.shard_tree(params, rd.param_specs(cfg, params, ctx), ctx)
            res[m] = {"logits": run(local, caches, rows, ctx), "rows": (rows.start, rows.stop),
                      "cut": sum(a.shape[2] < w.shape[2] for a, w in
                                 zip(tree.tensors(caches), tree.tensors(whole)) if a.ndim > 2)}
    return res


def seq_serve_case(name, driver, meshes, inp):
    """``ServeEngine(ctx=)`` with ``seq_shard`` against the unsharded engine on
    the same requests (:data:`SEQ_SERVE`): the continuous driver on (1, 4)
    and (2, 2), the loop on (2, 2), the chunked driver on (1, 4)."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model
    from repro_torch.serve.serving import Request, ServeEngine

    arch, over, max_seq, _s = SEQ_CASES[name]
    cfg = _cfg(arch, **over)
    model = Model(cfg)
    params = params_from_numpy(inp["params"], device="cpu")
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, min(n, max_seq // 2))
                    .astype(np.int32), max_new_tokens=m) for n, m in SEQ_SERVE]
    out = {}
    for m in (None,) + SEQ_SERVE_MESHES[driver]:
        ctx = None if m is None else rd.ShardCtx(meshes[m], seq_shard=True)
        tree_ = params if ctx is None else \
            rd.shard_tree(params, rd.param_specs(cfg, params, ctx), ctx)
        eng = ServeEngine(model, tree_, batch=2, max_seq=max_seq, decode=driver, ctx=ctx,
                          device="cpu")
        with torch.no_grad():
            toks = eng.generate(reqs)
        out[m or "unsharded"] = {"tokens": toks, "admissions": list(eng.admissions),
                                 "host_syncs": eng.host_syncs,
                                 "buckets": dict(eng.bucket_counts)}
    return out


def _ref_state(ref: dict, key: str):
    """The reference's train state ``ref[key]`` (a dict of numpy trees) as the
    port's ``TrainState`` on the CPU."""
    import types

    from repro_torch.convert import train_state_from_numpy

    return train_state_from_numpy(types.SimpleNamespace(**ref[key]), device="cpu")


def _paths(t, prefix=""):
    """``(path, leaf)`` of every tensor leaf, dict keys sorted."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _paths(t[k], f"{prefix}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _paths(v, f"{prefix}/{i}")
    elif t is not None:
        yield prefix, t


def _grad_err(got, want_slice, want_whole):
    """Worst leaf of ``max |got - want_slice| / max |want_whole leaf|`` (the
    rank's gradient shards against the same slices of a whole gradient),
    with its path."""
    worst = (0.0, "")
    for (path, a), (_p, b), (_q, w) in zip(_paths(got), _paths(want_slice), _paths(want_whole)):
        assert a.shape == b.shape, (path, a.shape, b.shape)
        err = float((a - b).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, (err, path))
    return worst


@contextlib.contextmanager
def split_k_sums():
    """Every dense matmul of the models sums its K in two halves, as a
    row-parallel layer over tp 2 does: the unsharded step under this is
    the unsharded step's own rounding spread under TP's reordering."""
    import torch

    from repro_torch.models import attention, ffn, layers, rwkv, ssm, transformer

    plain = layers.linear

    def split(p, x):
        if not (isinstance(p, dict) and isinstance(p.get("w"), torch.Tensor)):
            return plain(p, x)
        w, k = p["w"].to(x.dtype), p["w"].shape[-2] // 2
        y = x[..., :k] @ w[..., :k, :] + x[..., k:] @ w[..., k:, :]
        return y + p["b"].to(y.dtype) if "b" in p else y

    mods = (layers, attention, ffn, rwkv, ssm, transformer)
    for m in mods:
        m.linear = split
    try:
        yield
    finally:
        for m in mods:
            m.linear = plain


def _grad_bound(got, want_slice, want_whole, spread_slice):
    """Worst leaf of the sharded gradient's error over its bound: ``TOL_GRAD x
    max |want_whole leaf|``, or where the unsharded gradient itself moves
    more under TP's reordering of its sums (``spread_slice``: the same
    slice of it under :func:`split_k_sums`), ``SPREAD x`` that move.
    Returns ``(error / bound, path, error / leaf max, spread / leaf max)``."""
    worst = (0.0, "", 0.0, 0.0)
    for (path, a), (_p, b), (_q, w), (_r, c) in zip(_paths(got), _paths(want_slice),
                                                    _paths(want_whole), _paths(spread_slice)):
        scale = max(float(w.abs().max()), 1e-30)
        err, spread = float((a - b).abs().max()) / scale, float((c - b).abs().max()) / scale
        worst = max(worst, (err / max(TOL_GRAD, SPREAD * spread), path, err, spread))
    return worst


def train_case(name, meshes, ref):
    """One sharded train step against the port's unsharded step on the global
    batch: gradients (``make_grads_fn``), ``loss``, ``grad_norm`` and the
    parameters after the step (``make_train_step``); chatglm3-6b starts from
    the reference's state and batch and is also held to the reference's step."""
    import torch

    from repro_torch import dist as rd
    from repro_torch import tree
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    arch, accum = TRAIN_CASES[name]
    cfg = _cfg(arch)
    model = Model(cfg)
    if arch == "chatglm3-6b":
        state = _ref_state(ref, "state")
        batch = {"tokens": torch.from_numpy(ref["tokens"])}
    else:
        state = ts.init_train_state(model, 0, device="cpu")
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 13)))}
        if cfg.frontend is not None:
            batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
                (4, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32))
    ctx = rd.ShardCtx(meshes["dm"], fsdp=True)
    sspec = ts.train_state_specs(cfg, ctx)
    local = rd.shard_tree(state, sspec, ctx)
    rows = rd.runtime.rows_of(4, ctx)
    lbatch = {k: v[rows] for k, v in batch.items()}
    ocfg = opt.AdamWConfig(lr=1e-3)
    kw = dict(remat=True, accum_steps=accum)
    (_l0, _x0), g0 = ts.make_grads_fn(model, **kw)(state.params, batch)
    with split_k_sums():
        (_l2, _x2), g_split = ts.make_grads_fn(model, **kw)(state.params, batch)
    (_l1, _x1), g1 = ts.make_grads_fn(model, ctx=ctx, **kw)(local.params, lbatch)
    want, wm = ts.make_train_step(model, ocfg, **kw)(state, batch)
    got, gm = ts.make_train_step(model, ocfg, ctx=ctx, **kw)(local, lbatch)
    cut = lambda t: rd.shard_tree(t, sspec.params, ctx)         # noqa: E731
    ratio, grad_path, grad_rel, spread = _grad_bound(g1, cut(g0), g0, cut(g_split))
    out = {"grad_ratio": ratio, "grad_path": grad_path, "grad_rel": grad_rel,
           "grad_spread": spread, "grad_rel_max": _grad_err(g1, cut(g0), g0),
           "sharded": any(a.shape != b.shape for a, b in
                          zip(tree.tensors(local.params), tree.tensors(state.params))),
           "loss_rel": abs(float(gm["loss"]) - float(wm["loss"])) / abs(float(wm["loss"])),
           "grad_norm_rel": abs(float(gm["grad_norm"]) - float(wm["grad_norm"]))
           / float(wm["grad_norm"]),
           "param_abs": max(float((a - b).abs().max()) for a, b in
                            zip(tree.tensors(got.params), tree.tensors(cut(want.params)))),
           "loss": float(gm["loss"]), "step": int(got.step)}
    if name == "chatglm3-6b":
        from repro_torch.convert import params_from_numpy

        rg = params_from_numpy(ref["grads"], device="cpu")
        out["ref_grad_rel"], out["ref_grad_path"] = _grad_err(g1, cut(rg), rg)
        out["ref_loss_abs"] = abs(float(gm["loss"]) - ref["loss"])
        out["ref_param_abs"] = max(
            float((a - b).abs().max()) for a, b in
            zip(tree.tensors(got.params), tree.tensors(cut(_ref_state(ref, "new").params))))
    return out


def elastic_case(out_dir, meshes, ref):
    """The reference's save of its stepped chatglm3-6b train state (on its
    (2, 2) mesh), restored by the port on three meshes; then the port's
    sharded save of the same state from (2, 2)."""
    import torch

    from repro_torch import dist as rd
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models.model import Model
    from repro_torch.train import train_step as ts

    cfg = _cfg("chatglm3-6b")
    saved = _ref_state(ref, "new")
    like = ts.init_train_state(Model(cfg), 0, device="meta")
    out = {}
    for name in ELASTIC_MESHES:
        ctx = rd.ShardCtx(meshes[name], fsdp=True)
        sspec = ts.train_state_specs(cfg, ctx)
        got = ckpt.restore(os.path.join(out_dir, "ref_ckpt"), REF_STEP, like, device="cpu",
                           shardings=rd.to_shardings(sspec, ctx.mesh))
        want = rd.shard_tree(saved, sspec, ctx)
        pairs = list(zip(ckpt._flatten(got, []), ckpt._flatten(want, [])))
        out[name] = {"equal": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
                     "leaves": len(pairs),
                     "sharded": sum(a.numel() < w.numel() for (a, _b), w in
                                    zip(pairs, ckpt._flatten(saved, [])))}
    ctx = rd.ShardCtx(meshes["dm"], fsdp=True)
    sspec = ts.train_state_specs(cfg, ctx)
    local, shardings = rd.shard_tree(saved, sspec, ctx), rd.to_shardings(sspec, ctx.mesh)
    ckpt.save(os.path.join(out_dir, "port_ckpt"), REF_STEP, local, shardings=shardings)
    writer = ckpt.AsyncCheckpointer(os.path.join(out_dir, "port_async"))
    writer.save(REF_STEP, local, shardings=shardings)
    writer.wait()
    return out


def launch_case(out_dir, meshes):
    """``launch/train.py``'s sharded body on (2, 2): 4 steps with a failure at
    step 2 against a clean sharded run and the unsharded launcher (f32);
    ``--mesh single`` in this world of 4."""
    import torch
    import torch.distributed as dist

    from repro_torch import dist as rd
    from repro_torch import tree
    from repro_torch.launch import train as lt

    lt.get_config = lambda arch, smoke: _cfg(arch)            # f32, as every case here
    ctx = rd.ShardCtx(meshes["dm"], fsdp=True)
    runs = {}
    for name, extra, c in (("faulty", ["--fail-at", "2"], ctx), ("clean", [], ctx),
                           ("plain", [], None)):
        d = os.path.join(out_dir, f"launch_{name}" + (f"{dist.get_rank()}" if c is None else ""))
        runs[name] = lt.train(lt.parse(LAUNCH_ARGV + extra + ["--ckpt-dir", d]), c)
    (faulty, f_restarts, f_losses), (clean, _r, c_losses), (_p, _r2, p_losses) = \
        runs["faulty"], runs["clean"], runs["plain"]
    try:
        lt.main(["--mesh", "single", "--device", "cpu"])
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    return {"restarts": f_restarts, "step": int(faulty.step),
            "bit_equal": all(torch.equal(a, b) for a, b in
                             zip(tree.tensors(faulty.params) + tree.tensors(faulty.opt),
                                 tree.tensors(clean.params) + tree.tensors(clean.opt))),
            "losses": c_losses, "faulty_losses": f_losses, "plain_losses": p_losses,
            "loss_abs": max(abs(a - b) for a, b in zip(c_losses, p_losses)),
            "refusal": refusal}


def _wait_for_reference(out_dir: str, timeout_s: float = 300.0) -> dict:
    """The JAX child's ``ref_ep.pkl`` once it is there (written whole, then
    renamed into place)."""
    import time

    path = os.path.join(out_dir, "ref_ep.pkl")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no {path} after {timeout_s} s (the reference child failed?)")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


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
                                          mesh_dim_names=("pod", "data", "model")),
                  "d4": init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model")),
                  "m4": init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))}
        res["forward"] = {name: forward_case(name, meshes) for name in FORWARD_CASES}
        res["global_amax"] = global_amax_case(meshes)
        res["pipeline"] = pipeline_case()
        res["psum"] = psum_case()
        res["serve"] = {d: serve_case(d, meshes) for d in SERVE_DRIVERS}
        res["seq_steps"] = seq_shard_steps_case(meshes)
        seq_in = {name: seq_inputs(name) for name in SEQ_CASES}
        res["seq"] = {name: seq_case(name, meshes, seq_in[name]) for name in SEQ_CASES}
        res["seq_serve"] = {(name, d): seq_serve_case(name, d, meshes, seq_in[name])
                            for name in SEQ_CASES for d in SERVE_DRIVERS}
        ref = _wait_for_reference(out_dir)["train"]
        res["ep"] = ep_case(out_dir, meshes)
        res["train"] = {name: train_case(name, meshes, ref) for name in TRAIN_CASES}
        res["elastic"] = elastic_case(out_dir, meshes, ref)
        res["launch"] = launch_case(out_dir, meshes)
        dist.destroy_process_group()
    except Exception:                       # the test reads the traceback
        res["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
