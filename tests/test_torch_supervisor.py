"""Port: fault-tolerant training (``repro_torch.ft.supervisor.run_supervised``),
the mirror of the training cases of tests/test_fault_tolerance.py — exact
replay after injected restarts, exhausted restarts, a kill in the middle of a
checkpoint write, the refusal of a foreign checkpoint — plus the training
launcher and the port's fault-tolerant training example (CPU)."""

import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device  # noqa: E402
from repro_torch.ft import supervisor as sup  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(arch="chatglm3-6b"):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
        prefix_seq=cfg.frontend_seq if cfg.frontend else 0,
        prefix_dim=cfg.frontend_dim if cfg.frontend else 0))
    step = ts.make_train_step(model, opt.AdamWConfig(lr=1e-3), remat=False)
    init = lambda dev: ts.init_train_state(model, 0, device=dev)  # noqa: E731
    return init, step, lambda i: to_device(data.batch_at(i), "cpu")


def _run(tmp_path, fail_at, n_steps=12, tag="a", arch="chatglm3-6b"):
    init, step, batch_at = _setup(arch)
    losses = {}
    state, restarts = sup.run_supervised(
        cfg=sup.SupervisorConfig(ckpt_dir=str(tmp_path / tag), ckpt_every=4),
        init_state_fn=init, train_step_fn=step, batch_at=batch_at, n_steps=n_steps,
        injector=sup.FailureInjector(fail_at_steps=fail_at),
        on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])),
        device="cpu",
    )
    return state, restarts, losses


def _leaves(state):
    return tree.tensors(state.params) + tree.tensors(state.opt["mu"]) + [state.step]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "internvl2-1b"])
def test_restart_reproduces_exact_trajectory(tmp_path, arch):
    """Failures at steps 6 and 9 (restores from the steps-4 and -8
    checkpoints): the final state equals the clean run's bit for bit, and
    the losses after the last failure step for step (the reference's
    tolerance, rtol 1e-6, holds with room)."""
    state_f, restarts_f, losses_f = _run(tmp_path, fail_at=(6, 9), tag="faulty", arch=arch)
    state_c, restarts_c, losses_c = _run(tmp_path, fail_at=(), tag="clean", arch=arch)
    assert restarts_f == 2 and restarts_c == 0
    assert int(state_f.step) == int(state_c.step) == 12
    for a, b in zip(_leaves(state_f), _leaves(state_c)):
        assert torch.equal(a, b)
    for s in range(10, 13):
        assert losses_f[s] == losses_c[s]


def test_exhausted_restarts_raise(tmp_path):
    init, step, batch_at = _setup()
    with pytest.raises(sup.InjectedFailure):
        sup.run_supervised(
            cfg=sup.SupervisorConfig(ckpt_dir=str(tmp_path / "x"), ckpt_every=100,
                                     max_restarts=1),
            init_state_fn=init, train_step_fn=step, batch_at=batch_at, n_steps=5,
            # step 0 never checkpoints -> restart loops until exhausted
            injector=sup.FailureInjector(fail_at_steps=(0, 1, 2)), device="cpu",
        )


def test_mid_checkpoint_kill_restores_previous_step(tmp_path):
    """A crash mid-checkpoint-write (torn dir, no _COMMITTED) rolls the
    restart back to the previous committed step."""
    tag = "torn"
    state_c, _, _ = _run(tmp_path, fail_at=(), tag=tag)
    d = str(tmp_path / tag)
    os.makedirs(os.path.join(d, "step_000000016"))
    assert ckpt.latest_step(d) == 12         # torn step 16 is invisible
    state_r, restarts, _ = _run(tmp_path, fail_at=(), tag=tag)
    assert restarts == 0
    for a, b in zip(_leaves(state_c), _leaves(state_r)):
        assert torch.equal(a, b)


def test_restore_validation_rejects_foreign_checkpoint(tmp_path):
    """A committed checkpoint from a different structure fails loudly
    (non-retryable), not by silently mis-unflattening into the state."""
    d = tmp_path / "foreign"
    ckpt.save(str(d), 4, {"not": {"the": torch.zeros((3, 3))}})
    init, step, batch_at = _setup()
    with pytest.raises(ValueError, match="leaves|structure"):
        sup.run_supervised(
            cfg=sup.SupervisorConfig(ckpt_dir=str(d), ckpt_every=4),
            init_state_fn=init, train_step_fn=step, batch_at=batch_at, n_steps=8,
            device="cpu",
        )


def test_train_state_checkpoint_round_trip(tmp_path):
    """A ``TrainState`` is saved leaf by leaf (parameters, moments, steps)
    and restored into the structure built on the ``meta`` device."""
    init, step, batch_at = _setup("internvl2-1b")
    state, _ = step(init(torch.device("cpu")), batch_at(0))
    ckpt.save(str(tmp_path / "c"), 1, state)
    like = init(torch.device("meta"))
    assert like.params["embed"].device.type == "meta"
    back = ckpt.restore(str(tmp_path / "c"), 1, like, device="cpu")
    assert isinstance(back, ts.TrainState)
    for a, b in zip(_leaves(state) + tree.tensors(state.opt["nu"]) + [state.opt["step"]],
                    _leaves(back) + tree.tensors(back.opt["nu"]) + [back.opt["step"]]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_with_a_failure(tmp_path, capsys):
    """``launch.train --arch internvl2-1b --smoke --steps 20 --device cpu
    --fail-at 7``: one restart, the loss falls; ``--mesh`` without a world
    of 256 ranks refuses with the mesh's message."""
    from repro_torch.launch import train as ltrain

    state, restarts, losses = ltrain.main([
        "--arch", "internvl2-1b", "--smoke", "--steps", "20", "--device", "cpu",
        "--fail-at", "7", "--ckpt-dir", str(tmp_path / "ck")])
    assert restarts == 1 and len(losses) == 20 + 7 and int(state.step) == 20
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert "1 restarts" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="need 256 devices for mesh"):
        ltrain.main(["--mesh", "single", "--device", "cpu"])


def test_example_train_fault_tolerant_torch(tmp_path, monkeypatch):
    """examples/train_fault_tolerant_torch.py on the CPU: two injected
    failures survived, the loss falls, the trajectory equals a clean run's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["train_fault_tolerant_torch.py", "--device", "cpu"])
    runpy.run_path(os.path.join(ROOT, "examples", "train_fault_tolerant_torch.py"),
                   run_name="__main__")


@pytest.mark.cuda
def test_cuda_training_under_flash_raises():
    """On the card the flash kernel has no backward: a train step of an
    ``attn_impl="flash"`` config refuses (kernels/ops.py::_refuse_grad),
    where ``"xla"`` trains.  (In a file that imports no JAX: the card's
    machine has none.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses

    cfg = dataclasses.replace(get_config("internvl2-1b", smoke=True), attn_impl="flash")
    model = build_model(cfg)
    state = ts.init_train_state(model, 0, device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                                  prefix_seq=cfg.frontend_seq, prefix_dim=cfg.frontend_dim))
    batch = to_device(data.batch_at(0), "cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ts.make_train_step(model, opt.AdamWConfig())(state, batch)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    _, m = ts.make_train_step(xla, opt.AdamWConfig())(state, batch)
    assert np.isfinite(float(m["loss"]))
