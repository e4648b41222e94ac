"""Example: sharded training through the PyTorch/CUDA port (``repro_torch.dist``,
``repro_torch.train``).

Every rank builds the same seeded train state and keeps its shard (FSDP +
tensor parallel on a ``(data N/2, model 2)`` smoke mesh: the dense matrices'
output or input dim over ``model``, their other matrix dim over ``data``),
takes its ``data`` rows of each batch of the learnable ``PatternLM`` stream,
and trains under ``run_supervised(state_shardings=)`` with one injected
failure: the checkpoints are gathered whole and written by rank 0, the
restart restores every rank's shard from them, and the run goes on to the
losses of a run without the failure.  Rank 0 prints them; with ``--check``
it also trains the whole state without a mesh and prints how far the two
runs' losses are apart.

Run one process per rank, e.g. on one host:

    # 4 ranks on the CPU (gloo), a (data 2, model 2) mesh
    GLOO_SOCKET_IFNAME=lo PYTHONPATH=src python -m torch.distributed.run \\
        --nproc-per-node 4 examples/train_sharded_torch.py --device cpu --check
    # N cards (NCCL), one rank a card
    PYTHONPATH=src torchrun --nproc-per-node N examples/train_sharded_torch.py

A world of one rank (``chip_smoke.py --phase dist_train``) and two ranks
sharing one card have run on the GPU; the multi-rank semantics are held on
CPU gloo worlds (``tests/test_torch_sharded.py``).
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import devices
from repro_torch.dist import ShardCtx
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_smoke_mesh

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="chatglm3-6b")
ap.add_argument("--steps", type=int, default=6)
ap.add_argument("--fail-at", type=int, default=3)
ap.add_argument("--device", default="cuda")
ap.add_argument("--check", action="store_true", help="rank 0 also trains unsharded")
args = ap.parse_args()

dev = devices.resolve(args.device)
if dev.type == "cuda":
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
world, rank = dist.get_world_size(), dist.get_rank()
ctx = ShardCtx(make_smoke_mesh(world, device=dev.type), fsdp=True)

with tempfile.TemporaryDirectory() as tmp:
    ckpt_dir = os.path.join(tmp, "sharded")
    dist.broadcast_object_list(box := [ckpt_dir], src=0)      # rank 0's directory for all
    argv = ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(world),
            "--seq", "16", "--lr", "1e-3", "--ckpt-every", "2", "--device", args.device,
            "--fail-at", str(args.fail_at)]
    _state, restarts, losses = launcher.train(launcher.parse(argv + ["--ckpt-dir", box[0]]),
                                               ctx)
    if rank == 0:
        print(f"sharded: {restarts} restarts, losses {[round(x, 5) for x in losses]}")
        if args.check:
            _s, _r, plain = launcher.train(launcher.parse(
                argv + ["--ckpt-dir", os.path.join(tmp, "plain")]))
            after = args.steps - args.fail_at          # the steps after the failure
            err = max(abs(a - b) for a, b in zip(losses[-after:], plain[-after:]))
            print(f"unsharded: losses {[round(x, 5) for x in plain]}; the last {after} "
                  f"{err:.3e} from the sharded run's")
    dist.barrier()
dist.destroy_process_group()
