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
each batch; their positions are dropped before the loss.  One process, one
device: ``--mesh single|multi`` (the reference's FSDP / tensor-parallel
meshes) raises until sharded training lands (ROADMAP Queue 1, "Sharded
training"; the sharded forward and serving are ported: ``repro_torch.dist``).

Examples:
    # the CPU, smoke size, one injected failure
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b --smoke --steps 20 --device cpu --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --smoke --steps 20 --batch 4 --seq 64 --device cpu
    # the GPU, internvl2-1b at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b --full --steps 10 --batch 4 --seq 512 --ckpt-dir build/train_ckpt
"""

from __future__ import annotations

import argparse
import time

from repro_torch import devices
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, PatternLM, to_device
from repro_torch.ft import supervisor as sup
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def main(argv=None):
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
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(
            f"--mesh {args.mesh}: sharded training (the reference's production mesh, FSDP + "
            f"tensor parallel) is not ported; it is the next distribution item of "
            f"ROADMAP Queue 1, 'Sharded training'"
        )
    dev = devices.resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    data = PatternLM(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
            prefix_seq=cfg.frontend_seq if cfg.frontend else 0,
            prefix_dim=cfg.frontend_dim if cfg.frontend else 0,
        )
    )
    step_fn = ts.make_train_step(model, opt.AdamWConfig(lr=args.lr), remat=True)

    t0 = time.time()
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == args.steps:
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} ({time.time() - t0:.1f}s)", flush=True
            )

    state, restarts = sup.run_supervised(
        cfg=sup.SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        init_state_fn=lambda d: ts.init_train_state(model, 0, device=d),
        train_step_fn=step_fn,
        batch_at=lambda i: to_device(data.batch_at(i), dev),
        n_steps=args.steps,
        injector=sup.FailureInjector(fail_at_steps=tuple(args.fail_at)),
        on_metrics=on_metrics,
        device=dev,
    )
    print(f"done: {args.steps} steps, {restarts} restarts, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return state, restarts, losses


if __name__ == "__main__":
    main()
