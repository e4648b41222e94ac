"""Example: fault-tolerant training with injected failures, through the
PyTorch/CUDA port (``repro_torch``; the same run as
examples/train_fault_tolerant.py).

Trains a reduced chatglm3 on a learnable synthetic pattern while the failure
injector kills the 'job' twice; the supervisor restores from the latest
committed checkpoint each time and the loss trajectory continues exactly as
if nothing happened (counter-based data = exact replay): a clean run of the
same steps gives the same losses and the same final parameters.

Run:  PYTHONPATH=src python examples/train_fault_tolerant_torch.py            # the card
      PYTHONPATH=src python examples/train_fault_tolerant_torch.py --device cpu
"""

import argparse
import shutil

import numpy as np
import torch

from repro_torch import devices, tree
from repro_torch.configs import get_config
from repro_torch.ft import supervisor as sup
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = devices.resolve(ap.parse_args().device)

cfg = get_config("chatglm3-6b", smoke=True)
model = build_model(cfg)
step = ts.make_train_step(model, opt.AdamWConfig(lr=2e-3), remat=False)


def batch_at(i):
    rng = np.random.default_rng(i)
    start = rng.integers(0, cfg.vocab_size, (4, 1))
    seq = (start + np.arange(17)[None]) % cfg.vocab_size
    return {"tokens": torch.from_numpy(seq.astype(np.int32)).to(dev)}


def run(ckpt_dir, fail_at):
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = {}
    state, restarts = sup.run_supervised(
        cfg=sup.SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=5),
        init_state_fn=lambda d: ts.init_train_state(model, 0, device=d),
        train_step_fn=step,
        batch_at=batch_at,
        n_steps=25,
        injector=sup.FailureInjector(fail_at_steps=fail_at),
        on_metrics=lambda s, m: (
            losses.__setitem__(s, float(m["loss"])),
            print(f"step {s:3d} loss {float(m['loss']):.4f}") if fail_at and s % 5 == 0 else None,
        ),
        device=dev,
    )
    return state, restarts, losses


state, restarts, losses = run("runs/example_ft_torch_ckpt", (8, 17))
clean, _, clean_losses = run("runs/example_ft_torch_clean", ())
print(f"\nsurvived {restarts} injected failures; loss {losses[1]:.3f} -> {losses[25]:.3f}")
assert restarts == 2 and losses[25] < losses[1]
assert losses == clean_losses
assert all(torch.equal(a, b) for a, b in zip(tree.tensors(state.params),
                                             tree.tensors(clean.params)))
print("fault-tolerant training example (repro_torch) OK")
