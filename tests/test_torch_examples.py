"""The port's counterparts of the reference's examples
(``examples/*_torch.py``) on the CPU.

Each example runs in-process with ``runpy`` and ``--device cpu``, as
``tests/test_torch_supervisor.py::test_example_train_fault_tolerant_torch``
runs its training example (once a module, its output shared by the tests
that read it), and must end with its reference's last line.
Where the reference example prints a number that comes from shapes or
integers (the LUT and packed bytes and the perf model's p* in the
quickstart, the parameter bytes of the served model, the plans' bytes in the
autotuned serve), the port's printed number is held to the reference
library's value, computed here in-process; the reference's example scripts
themselves are not run.  A subprocess imports all five and finds neither
``jax`` nor ``repro`` in ``sys.modules``.
"""

import contextlib
import dataclasses
import io
import os
import re
import runpy
import subprocess
import sys
import textwrap

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = ("quickstart", "serve_quantized_llm", "autotune_serve", "live_ops_serve",
            "lut_gemm_kernels")
LAST_LINE = {
    "quickstart": "quickstart OK",
    "serve_quantized_llm": "serve example OK",
    "autotune_serve": re.compile(r"served 3 requests through the plan; tokens identical to "
                                 r"the fixed spec: \[\[.*\]\]"),
    "live_ops_serve": "live-ops serving example OK",
    "lut_gemm_kernels": "kernel demo OK",
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(name)``: the stdout lines of ``examples/<name>_torch.py --device
    cpu``, run once a module in-process (``runpy``) from a directory of its
    own, with one torch thread (the examples are toy-sized; several test
    workers share the host)."""
    outs: dict = {}

    def one(name):
        if name not in outs:
            where = tmp_path_factory.mktemp(name)
            buf, argv, cwd, threads = io.StringIO(), sys.argv, os.getcwd(), torch.get_num_threads()
            sys.argv = [f"{name}_torch.py", "--device", "cpu"]
            os.chdir(where)
            torch.set_num_threads(1)
            try:
                with contextlib.redirect_stdout(buf):
                    runpy.run_path(os.path.join(os.path.abspath(ROOT), "examples",
                                                f"{name}_torch.py"), run_name="__main__")
            finally:
                sys.argv = argv
                os.chdir(cwd)
                torch.set_num_threads(threads)
            outs[name] = buf.getvalue().strip().splitlines()
        return outs[name]

    return one


def _ints(line: str) -> list[int]:
    return [int(t.replace(",", "")) for t in re.findall(r"\d[\d,]*", line)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_ends_with_its_references_last_line(name, run):
    lines = run(name)
    want = LAST_LINE[name]
    if isinstance(want, str):
        assert lines[-1] == want, lines[-5:]
    else:
        assert want.fullmatch(lines[-1]), lines[-5:]
    if name == "lut_gemm_kernels":
        assert "no card: the entry points run the kernels' plain versions" in lines
        assert sum("plain version: " in ln for ln in lines) == 5, lines


def test_quickstart_prints_the_reference_librarys_lut_and_plan_numbers(run):
    """The LUT shapes and bytes, the perf model's choice and the packed bytes
    the quickstart prints are the reference library's."""
    from repro.core import api as japi
    from repro.core import luts as jluts
    from repro.core import perfmodel as jperf

    lines = run("quickstart")
    jpack = jluts.build_lut_pack(2, 4, 3)
    text = "\n".join(lines)
    assert f"canonical LUT: {jpack.canonical.shape}  ({jpack.canonical_bytes:,} B)" in text
    assert f"reordering LUT: {jpack.reordering.shape} ({jpack.reordering_bytes:,} B)" in text
    assert f"{jluts.packed_lut_bytes(2, 4, 3, jpack.bo):,} B " in text
    plan = jperf.make_plan(jperf.PlanInputs(m=3072, k=768, n=128, bw=1, ba=3))
    assert (f"p*={plan.p_star} streaming={plan.use_streaming} (p_local={plan.p_local}, "
            f"p_dram={plan.p_dram})") in text
    q = japi.quantize_linear(jax.numpy.zeros((64, 48), jax.numpy.float32) + 1.0,
                             japi.LutLinearSpec(bw=2, ba=4, mode="dequant"))
    assert f"dense bytes {64 * 48 * 4:,} -> packed {q.packed_bytes:,}" in text
    assert "LUT GEMM bit-exact vs oracle (16x24x8) on cpu" in text


def test_served_model_bytes_are_the_reference_librarys(run):
    """The dense and packed parameter bytes of the served stablelm-12b smoke
    model are those of the reference's tree of the same config."""
    from repro.configs import get_config as jget_config
    from repro.core import LutLinearSpec as JSpec
    from repro.models.model import build_model as jbuild

    lines = run("serve_quantized_llm")
    jm = jbuild(jget_config("stablelm-12b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jq = jm.quantize(jp, JSpec(bw=4, ba=4, mode="dequant"))
    nbytes = lambda t: sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(t))  # noqa: E731
    dense, packed = _ints(lines[0])[:2]
    assert (dense, packed) == (nbytes(jp), nbytes(jq)), lines[0]


def test_autotune_plans_spend_the_reference_planners_bytes(run):
    """Both plans' spent and budget bytes, and each layer's bytes, are the
    reference planner's on the reference's tree of the same config (analytic
    plans depend on the shapes alone)."""
    from repro.configs import get_config as jget_config
    from repro.core import LutLinearSpec as JSpec
    from repro.models.model import build_model as jbuild
    from repro.tune import plan_model as jplan_model

    lines = run("autotune_serve")
    cfg = dataclasses.replace(
        jget_config("stablelm-12b", smoke=True), name="autotune-demo",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=128)
    jm = jbuild(cfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    heads = [i for i, ln in enumerate(lines) if ln.startswith("=== ")]
    assert len(heads) == 2, lines
    for at, budget in zip(heads, (4 << 20, 2 << 10)):
        jplan = jplan_model(jq, lut_budget_bytes=budget, n_hint=2, measure=False)
        assert _ints(lines[at])[-2:] == [jplan.total_bytes, jplan.budget_bytes], lines[at]
        rows = lines[at + 1: at + 1 + len(jplan.layers)]
        for row, (path, lp) in zip(rows, sorted(jplan.layers.items())):
            assert row.split()[0] == path and _ints(row)[-1] == lp.capacity_bytes, row
            assert f"p={lp.p}" in row and ("+wcanon" in row) == lp.wcanon, row


def test_examples_import_neither_jax_nor_the_reference(tmp_path):
    """A fresh interpreter runs all five examples on the CPU: no ``jax`` and
    no ``repro`` module is loaded."""
    code = textwrap.dedent(f"""
        import contextlib, io, runpy, sys, os
        import torch
        torch.set_num_threads(1)
        for name in {EXAMPLES!r}:
            sys.argv = [name, "--device", "cpu"]
            with contextlib.redirect_stdout(io.StringIO()):
                runpy.run_path(os.path.join({os.path.abspath(ROOT)!r}, "examples",
                                            name + "_torch.py"), run_name="__main__")
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
        print("loaded:", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.abspath(ROOT), "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, (res.stdout, res.stderr[-2000:])
    assert "loaded: []" in res.stdout
