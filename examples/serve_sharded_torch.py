"""Example: sharded serving through the PyTorch/CUDA port (``repro_torch.dist``).

Every rank builds the same seeded quantized tree, cuts its own shard
(``shard_tree`` under ``param_specs``: codes along the output dim over the
``model`` axis, the embedding over the vocabulary, expert stacks over the
experts), prepares it, and serves the same requests through
``ServeEngine(ctx=)``: the batch's slots split over the ``data`` axis, each
projection run on the rank's F-shard and all-gathered.  Every rank prints
the same tokens; with ``--check`` rank 0 also serves the whole tree
without a ctx and asserts that they are equal.  ``--seq-shard`` also cuts the
caches along the sequence on the ``model`` axis (the long-context layout: a
cache dim of at least 1024 positions that ``--tp`` divides, so give
``--max-seq`` 1024 or more), and the attention runs context-parallel over the
ranks' slices.

Run one process per rank, e.g. on one host:

    # 4 ranks on the CPU (gloo), a (data 2, model 2) mesh
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples/serve_sharded_torch.py --device cpu --tp 2 --check
    # the same with each rank holding half of every cache's 2048 positions
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples/serve_sharded_torch.py --device cpu --tp 2 --check \\
        --seq-shard --max-seq 2048
    # N cards (NCCL), one rank a card
    PYTHONPATH=src torchrun --nproc-per-node N examples/serve_sharded_torch.py --tp 2

Only a world of one rank (``chip_smoke.py --phase dist``) has run on a card
so far; the multi-rank semantics are held on CPU gloo worlds
(``tests/test_torch_sharded.py``).
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import dist as rd
from repro_torch import devices
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import LutLinearSpec
from repro_torch.models.model import build_model, prepare_params
from repro_torch.serve.serving import Request, ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="stablelm-12b", choices=list(ARCH_IDS))
ap.add_argument("--full", action="store_true", help="published widths (default: smoke)")
ap.add_argument("--tp", type=int, default=2, help="ranks on the model axis")
ap.add_argument("--mode", default="lut", choices=["lut", "pallas", "dequant"])
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--max-seq", type=int, default=64, help="cache positions a slot holds")
ap.add_argument("--seq-shard", action="store_true",
                help="cut the caches along the sequence on the model axis")
ap.add_argument("--device", default="cuda")
ap.add_argument("--check", action="store_true", help="rank 0 also serves unsharded")
args = ap.parse_args()
if args.check and get_config(args.arch).moe is not None:
    # Under expert parallelism a MoE layer counts its capacity over the rank's
    # dp rows (the reference's shard_map does too), so where the published
    # capacity factor drops slots the tokens are not the unsharded serve's.
    raise SystemExit("--check compares with the unsharded serve: not for an MoE config")

dev = devices.resolve(args.device)
if dev.type == "cuda":
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device("cuda", torch.cuda.current_device())
dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
world, rank = dist.get_world_size(), dist.get_rank()
if world % args.tp:
    raise SystemExit(f"--tp {args.tp} does not divide the world of {world} ranks")
mesh = init_device_mesh(dev.type, (world // args.tp, args.tp), mesh_dim_names=("data", "model"))
ctx = rd.ShardCtx(mesh, seq_shard=args.seq_shard)

cfg = get_config(args.arch, smoke=not args.full)
model = build_model(cfg)
spec = LutLinearSpec(bw=1, ba=3, p=4, mode="lut") if args.mode == "lut" else \
    LutLinearSpec(bw=4, ba=4, mode=args.mode)
full = model.init_quantized(spec, seed=0, device=dev)
local = prepare_params(rd.shard_tree(full, rd.param_specs(cfg, full, ctx), ctx), n_hint=4)

rng = np.random.default_rng(0)
reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8)
        for n in rng.integers(4, 24, 2 * args.batch)]
with torch.no_grad():
    eng = ServeEngine(model, local, batch=args.batch, max_seq=args.max_seq, ctx=ctx,
                      device=dev)
    outs = eng.generate(reqs)
    print(f"rank {rank} of {world} (mesh data {world // args.tp} x model {args.tp}"
          f"{', caches cut along the sequence' if args.seq_shard else ''}): "
          f"{eng.host_syncs} host syncs; tokens {outs}", flush=True)
    if args.check and rank == 0:
        plain = ServeEngine(model, prepare_params(full, n_hint=4), batch=args.batch,
                            max_seq=args.max_seq, device=dev).generate(reqs)
        assert plain == outs, "sharded tokens differ from the unsharded serve"
        print("sharded serve == unsharded serve", flush=True)
dist.destroy_process_group()
