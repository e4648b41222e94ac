"""The port's launchers with a plan, a prepared checkpoint or the durable
request log, on a smoke config on the CPU (W1A3 ``lut``, a few requests of a
few tokens): shared by the family test files, whose launchers once refused
these flags."""

import functools

import pytest

from repro_torch.launch import serve as lserve
from repro_torch.launch import tune as ltune
from repro_torch.tune import measure

def run_case(arch, case, tmp_path, capsys):
    """Run ``case`` through the launchers and check what it promises; returns
    the served tokens.  ``--prepared-ckpt``: the first run saves, the rerun
    restores and serves the same tokens.  ``--request-log``: a clean live
    serve, and a rerun over the same log replays every token from it (no new
    wave).  ``--autotune`` (each candidate timed once, without warmup, to
    keep the CPU time down), ``--plan`` and ``tune`` (the tune launcher's
    plan JSON served with ``--plan``): a planned serve; its tokens are held
    to the reference's in ``tests/test_torch_plans_families.py``."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--mode", "lut", "--bw", "1",
            "--ba", "3", "--requests", "3", "--prompt-len", "5", "--max-new", "3"]
    if case == "--prepared-ckpt":
        argv = [*base, "--prepared-ckpt", str(tmp_path / "ckpt")]
        outs = lserve.main(argv)
        assert lserve.main(argv) == outs
        out = capsys.readouterr().out
        assert "saved prepared checkpoint" in out and "restored prepared checkpoint" in out
    elif case == "--request-log":
        argv = [*base, "--request-log", str(tmp_path / "serve.jsonl")]
        outs = lserve.main(argv)
        assert lserve.main(argv) == outs
        out = capsys.readouterr().out
        assert "live serve: 0 restarts" in out and "0 host syncs" in out
    elif case == "--autotune":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(measure, "Measurer",
                       functools.partial(measure.Measurer, iters=1, warmup=0, cache={}))
            outs = lserve.main([*base, "--autotune", "4"])
        assert "autotuned" in capsys.readouterr().out
    else:
        plan = str(tmp_path / "plan.json")
        ltune.main(["--arch", arch, "--smoke", "--analytic", "--device", "cpu", "--out", plan])
        outs = lserve.main([*base, "--plan", plan])
        assert "loaded plan" in capsys.readouterr().out
    assert [len(o) for o in outs] == [3, 3, 3]
    return outs
