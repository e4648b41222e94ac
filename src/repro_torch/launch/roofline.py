"""Roofline over the dry-run's artifacts (port of ``benchmarks/roofline.py``):
three terms per (arch x shape) cell, for one rank of the mesh on an H100 SXM.

Reads ``runs/dryrun_torch/<mesh>/*.json`` (:mod:`repro_torch.launch.dryrun`)
and derives, per rank:

    compute term    = flops / peak bf16 FLOP/s
    memory term     = bytes_accessed / HBM bandwidth
    collective term = Σ over mesh axes of that axis's collective bytes /
                      the rate of the slowest link its groups cross

The production mesh is row-major with ``model`` the fast axis, and an HGX
node holds :attr:`~repro_torch.hw.GpuCard.gpus_per_node` GPUs: a group whose
ranks all sit in one node runs over NVLink, any other over the node's
network port (a ``model`` group of 16 spans two 8-GPU nodes; a ``data``
group spans 16).  These are derived figures, from shapes and the data
sheet, never measured ones; ``flops`` counts matrix products only and
``bytes_accessed`` is unfused (the dry-run's docstring).

MODEL_FLOPS uses 6·N·D for training and 2·N_active·D for inference steps (D =
tokens processed in the step, divided over the mesh's ranks); the MODEL/count
ratio flags recomputation and redundant compute, and the roofline fraction
is the least time a step must take — model FLOPs at the peak, or the
arguments read and the outputs written once at the HBM rate — over the
largest term.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--markdown] [--mesh single]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

from repro_torch import hw
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import RESULTS_DIR, SHAPES

CHIP = hw.H100_SXM
N_CHIPS = {"single": 256, "multi": 512}
LABEL = "derived from shapes and the H100 SXM data sheet at 700 W, not measured"


def model_flops_per_chip(arch: str, shape_name: str, n_chips: int = N_CHIPS["single"]) -> float:
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        tokens = sh["batch"] * sh["seq"]
        total = 6.0 * cfg.active_param_count() * tokens  # MoE: routed-active only
    elif sh["kind"] == "prefill":
        tokens = sh["batch"] * sh["seq"]
        total = 2.0 * cfg.active_param_count() * tokens
    else:  # decode: one token per sequence
        tokens = sh["batch"]
        total = 2.0 * cfg.active_param_count() * tokens
    return total / n_chips


def axis_link(axes: str, mesh_shape, mesh_axes, card: hw.GpuCard = CHIP) -> tuple:
    """``(link, bytes/s)`` of the slowest link crossed by the groups along
    ``axes`` (mesh axis names joined by ``+``) of a row-major mesh."""
    names = list(mesh_axes)
    along = [names.index(a) for a in axes.split("+")]
    groups: dict = {}
    for rank in range(math.prod(mesh_shape)):
        coords, r = [], rank
        for n in reversed(mesh_shape):
            coords.append(r % n)
            r //= n
        coords.reverse()
        key = tuple(c for i, c in enumerate(coords) if i not in along)
        groups.setdefault(key, set()).add(rank // card.gpus_per_node)
    if any(len(nodes) > 1 for nodes in groups.values()):
        return "network", card.network_bandwidth
    return "nvlink", card.nvlink_bandwidth


def cell_terms(rec: dict, card: hw.GpuCard = CHIP) -> dict | None:
    if rec.get("status") != "traced":
        return None
    full = rec.get("full_analysis", {})
    src = rec.get("calibrated") or full
    flops = float(src.get("flops", 0.0))
    byts = float(src.get("bytes_accessed", 0.0))
    coll = src.get("collective_bytes", {}) or {}
    links, t_coll = {}, 0.0
    for axes, b in (full.get("collective_bytes_by_axis") or {}).items():
        link, rate = axis_link(axes, rec["mesh_shape"], rec["mesh_axes"], card)
        links[axes] = link
        t_coll += float(b) / rate
    t_comp = flops / card.peak_flops_bf16
    t_mem = byts / card.hbm_bandwidth
    dominant = max(
        (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops_per_chip(rec["arch"], rec["shape"], math.prod(rec["mesh_shape"]))
    bound = max(t_comp, t_mem, t_coll)
    ideal_c = mf / card.peak_flops_bf16
    # A step must at least read its arguments and write its outputs once.
    min_bytes = float(full.get("argument_size_in_bytes", 0)) + float(
        full.get("output_size_in_bytes", 0)
    )
    ideal_m = min_bytes / card.hbm_bandwidth
    ideal = max(ideal_c, ideal_m)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "counted_flops_per_chip": flops,
        "model_over_counted": (mf / flops) if flops else 0.0,
        "roofline_fraction": min((ideal / bound) if bound else 0.0, 1.0),
        "mem_efficiency": min(min_bytes / byts, 1.0) if byts else 0.0,
        "collective_detail": coll,
        "collective_links": links,
        "min_bytes_per_chip": min_bytes,
    }


def load_cells(
    results_dir: str = RESULTS_DIR, mesh: str = "single", *, variants: bool = False
) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, mesh, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        is_variant = bool(rec.get("variant")) or (
            not rec.get("quantized", True) and rec["shape"] != "train_4k"
        )
        if is_variant != variants:
            continue
        rec["terms"] = cell_terms(rec)
        cells.append(rec)
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def _links(t: dict) -> str:
    return ",".join(f"{a}:{link}" for a, link in sorted(t["collective_links"].items())) or "-"


def rows(results_dir: str = RESULTS_DIR, mesh: str = "single"):
    """``(name, bound us, detail)`` per cell, as the reference's rows."""
    out = []
    if not glob.glob(os.path.join(results_dir, mesh, "*.json")):
        return [(
            "roofline/NO_ARTIFACTS", "",
            "no runs/dryrun_torch artifacts; generate with "
            f"PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh {mesh}",
        )]
    for rec in load_cells(results_dir, mesh):
        name = f"roofline/{rec['arch']}/{rec['shape']}"
        if rec.get("status") == "skipped":
            out.append((name, "", f"SKIP:{rec['skip_reason'][:60]}"))
            continue
        t = rec.get("terms")
        if not t:
            out.append((name, "", f"FAILED:{rec.get('error','')[:60]}"))
            continue
        out.append(
            (name, f"{max(t['t_compute_s'], t['t_memory_s'], t['t_collective_s'])*1e6:.1f}",
             f"comp={_fmt_s(t['t_compute_s'])};mem={_fmt_s(t['t_memory_s'])};"
             f"coll={_fmt_s(t['t_collective_s'])};links={_links(t)};dom={t['dominant']};"
             f"model/counted={t['model_over_counted']:.3g};"
             f"roofline={t['roofline_fraction']*100:.1f}%;"
             f"mem_eff={t['mem_efficiency']*100:.0f}%;trace_s={rec.get('t_trace_s')}")
        )
    for rec in load_cells(results_dir, mesh, variants=True):
        t = rec.get("terms")
        tag = rec.get("variant") or "dense"
        name = f"roofline-variant/{rec['arch']}/{rec['shape']}/{tag}"
        if not t:
            out.append((name, "", f"{rec.get('status')}"))
            continue
        out.append(
            (name, f"{max(t['t_compute_s'], t['t_memory_s'], t['t_collective_s'])*1e6:.1f}",
             f"comp={_fmt_s(t['t_compute_s'])};mem={_fmt_s(t['t_memory_s'])};"
             f"coll={_fmt_s(t['t_collective_s'])};dom={t['dominant']}")
        )
    return out


def markdown_table(results_dir: str = RESULTS_DIR, mesh: str = "single") -> str:
    cells = load_cells(results_dir, mesh)
    lines = [
        f"One rank of the {mesh} mesh ({N_CHIPS[mesh]} H100s), {LABEL}.",
        "",
        "| arch | shape | quant | compute | memory | collective (links) | dominant |"
        " MODEL/counted | roofline frac | mem eff | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    total, skipped = 0.0, {}
    for rec in cells:
        q = "W4A4" if rec.get("quantized") else ("-" if rec["shape"] == "train_4k" else "bf16")
        if rec.get("status") == "skipped":
            skipped.setdefault(rec["skip_reason"].split(":")[0], []).append(
                f"{rec['arch']} {rec['shape']}")
            continue
        t = rec.get("terms")
        if not t:
            lines.append(f"| {rec['arch']} | {rec['shape']} | {q} | FAILED | | | | | | | |")
            continue
        secs = rec.get("t_trace_s", 0.0) + rec.get("last_rank", {}).get("t_trace_s", 0.0)
        total += secs
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {q} | {_fmt_s(t['t_compute_s'])} |"
            f" {_fmt_s(t['t_memory_s'])} | {_fmt_s(t['t_collective_s'])} ({_links(t)}) |"
            f" {t['dominant']} | {t['model_over_counted']:.3g} |"
            f" {t['roofline_fraction']*100:.1f}% | {t['mem_efficiency']*100:.0f}% |"
            f" {secs:.1f} |"
        )
    lines.append("")
    for reason, names in skipped.items():
        lines.append(f"Skipped ({reason}): {', '.join(names)}.")
    lines.append(f"Trace seconds: rank 0 and the last rank together; all cells {total:.1f} s "
                 f"(host time, not a speed of the system).")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--markdown", action="store_true", help="print the markdown table")
    ap.add_argument("--mesh", default="single", choices=list(N_CHIPS))
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.markdown:
        print(markdown_table(args.results_dir, args.mesh))
        return
    print("name,us_per_step,derived")
    for name, value, detail in rows(args.results_dir, args.mesh):
        print(f"{name},{value},{detail}")


if __name__ == "__main__":
    main()
