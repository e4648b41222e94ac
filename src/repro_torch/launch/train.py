"""Training driver of the port: the fault-tolerant supervised loop with
checkpoint/restart (counterpart of ``repro.launch.train``).

Trains the model (random weights from seed 0, f32 parameters, the config's
compute dtype, each unit checkpointed) with AdamW on the counter-based
learnable stream :class:`repro_torch.data.pipeline.PatternLM` (rows that
count up from a seeded start; the reference's launcher draws uniform tokens,
which leave nothing to learn beyond the unigram, so a short run's loss only
drifts there), under :func:`repro_torch.ft.supervisor.run_supervised`:
the state is saved every ``--ckpt-every`` steps, and a failure injected at a
``--fail-at`` step restores the latest checkpoint and replays from there.  A
VLM config (internvl2-1b) draws its stub frontend's patch embeddings with
each batch; their positions are dropped before the loss.

``--mesh single|multi`` trains sharded, as the reference does on its
production meshes: ``make_production_mesh`` over ``torch.distributed`` (16 x 16
ranks, or 2 x 16 x 16; a smaller world refuses with the mesh's message),
``ShardCtx(dp_axes=<every axis but "model">, fsdp=True)`` — FSDP + tensor
parallel (:mod:`repro_torch.dist.runtime`).  Every rank builds the whole
state from seed 0 and keeps its shard, takes its dp rows of each batch
(``runtime.rows_of``), and trains under ``run_supervised(state_shardings=)``:
the checkpoints are gathered whole and written by global rank 0, and a
restore cuts each rank's shard, on any mesh.  Only global rank 0 prints.
:func:`train` takes the ``ShardCtx`` itself (a smoke mesh:
``examples/train_sharded_torch.py``, the CPU tests' gloo world).

Examples:
    # the CPU, smoke size, one injected failure
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b --smoke --steps 20 --device cpu --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --smoke --steps 20 --batch 4 --seq 64 --device cpu
    # the GPU, internvl2-1b at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b --full --steps 10 --batch 4 --seq 512 --ckpt-dir build/train_ckpt
    # sharded, 256 ranks (one a card; init_process_group from torchrun's environment)
    torchrun --nnodes 32 --nproc-per-node 8 -m repro_torch.launch.train --mesh single --full
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import devices
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, PatternLM, to_device
from repro_torch.dist import runtime
from repro_torch.dist.sharding import ShardCtx, mesh_axes, to_shardings
from repro_torch.ft import supervisor as sup
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="chatglm3-6b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True, help="reduced config")
    ap.add_argument("--full", dest="smoke", action="store_false", help="published widths")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="runs/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    ctx = None
    if args.mesh != "none":
        import torch.distributed as dist

        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:    # started by torchrun
            dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), device=args.device)
        dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
        ctx = ShardCtx(mesh=mesh, dp_axes=dp, fsdp=True)
    return train(args, ctx)


def train(args: argparse.Namespace, ctx=None):
    """The launcher's body: ``args`` as :func:`parse` gives them, ``ctx`` a
    :class:`~repro_torch.dist.ShardCtx` with a mesh (a sharded run: every
    rank calls this) or ``None``.  Returns ``(state, restarts, losses)``;
    the state is the rank's shards."""
    import torch.distributed as dist

    sharded = runtime.active(ctx)
    dev = devices.resolve(args.device)
    if sharded and dev.type == "cuda":              # one card a rank (torchrun's LOCAL_RANK)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    speak = not sharded or dist.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    data = PatternLM(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
            prefix_seq=cfg.frontend_seq if cfg.frontend else 0,
            prefix_dim=cfg.frontend_dim if cfg.frontend else 0,
        )
    )
    rows = runtime.rows_of(args.batch, ctx)
    step_fn = ts.make_train_step(model, opt.AdamWConfig(lr=args.lr), ctx=ctx, remat=True)
    shardings = to_shardings(ts.train_state_specs(cfg, ctx), ctx.mesh) if sharded else None

    t0 = time.time()
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if speak and (step % 10 == 0 or step == args.steps):
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} ({time.time() - t0:.1f}s)", flush=True
            )

    state, restarts = sup.run_supervised(
        cfg=sup.SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        init_state_fn=lambda d: ts.init_train_state(model, 0, device=d),
        train_step_fn=step_fn,
        batch_at=lambda i: to_device({k: v[rows] for k, v in data.batch_at(i).items()}, dev),
        n_steps=args.steps,
        injector=sup.FailureInjector(fail_at_steps=tuple(args.fail_at)),
        state_shardings=shardings,
        on_metrics=on_metrics,
        device=dev,
    )
    if speak:
        print(f"done: {args.steps} steps, {restarts} restarts, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}" + (f" (mesh {dict(mesh_axes(ctx.mesh))}, FSDP + TP)"
                                     if sharded else ""))
    return state, restarts, losses


if __name__ == "__main__":
    main()
