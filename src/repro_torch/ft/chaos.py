"""Deterministic chaos harness for the port's supervised serving stack
(counterpart of ``repro.ft.chaos``).

:func:`chaos_sweep` is a seeded fault-injection sweep that kills the
serving stack at every seam a real deployment dies at, and asserts the two invariants the live-ops layer
sells — **zero dropped requests** and **token-identical replay** — for every
single kill point.  Five seams:

* ``mid_wave`` — process death between an admission wave's durable log write
  and the engine's own bookkeeping (the classic window: tokens computed,
  never returned).  :class:`repro_torch.ft.supervisor.FailureInjector` at seeded
  wave numbers.
* ``mid_swap_stage`` — the background hot-swap stage dies mid-build (build
  raises, or the thread dies leaving neither tree nor error), with a process
  kill behind it.  The flip must surface the failure loudly
  (:meth:`repro_torch.serve.ops.StagedSwap.wait` /
  :meth:`repro_torch.serve.ops.SwapController.status`) and the active tree — and
  every in-flight token — must be untouched.
* ``mid_ckpt_write`` — the prepared-checkpoint fast-restore path is torn at
  seeded granularity (missing ``_COMMITTED``, a truncated leaf array, a
  corrupt manifest) and a mid-wave kill forces a restart through it: the
  engine factory must fall back to a cold prepare and replay identically
  (each fallback is counted: ``cold_fallbacks`` in the point's report).  The
  point's checkpoint directory is removed after its serve, so the sweep
  holds one checkpoint on disk at a time.
* ``mid_log_append`` — the process dies *inside* the request log's append,
  right after the record is durable (written + fsynced): replay must resume
  including that wave, with no duplicates.
* ``torn_tail`` — the process dies mid-``write``, leaving a torn partial
  line (seeded byte count, no newline): the restarted writer must heal the
  tail, replay must treat the torn wave as never-happened, and the re-run
  of that wave must produce the identical tokens.

Every fault is deterministic (seeded, no wall-clock dependence), so a red
chaos run reproduces bit-for-bit.  Identity is asserted against an
undisturbed reference run of the same engine — which is only meaningful on a
batch-composition-invariant tree; use a *calibrated* prepared tree
(``Model.prepare(..., calibrate=batch)``) so lut/stream engines are in the
bit-exact replay domain (see ``repro_torch/serve/ops.py``).  The engines
run on ``device`` (default ``"cuda"``), where ``prepared`` lives.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

from repro_torch.ft.supervisor import FailureInjector, InjectedFailure, RestartPolicy
from repro_torch.serve.ops import LiveServer, StagedSwap, SwapController
from repro_torch.serve.request_log import RequestLog
from repro_torch.serve.serving import Request, ServeEngine

SEAMS = (
    "mid_wave",
    "mid_swap_stage",
    "mid_ckpt_write",
    "mid_log_append",
    "torn_tail",
)


class ChaosLog(RequestLog):
    """A :class:`RequestLog` that dies at a seeded append.

    ``fail_after`` counts successful appends before the fault.  With
    ``torn_bytes=None`` the fault record is written durably (flushed +
    fsynced) and *then* the process "dies" — the mid-log-append seam.  With
    ``torn_bytes=k`` only the first ``k`` bytes of the record hit the disk,
    with no newline — the torn-tail seam.  The fault fires once; subsequent
    appends emulate the restarted process's reopen (truncating the torn
    bytes exactly as ``RequestLog.__init__`` would).
    """

    def __init__(self, path, *, fail_after: int,
                 torn_bytes: Optional[int] = None,
                 rotate_bytes: Optional[int] = None):
        super().__init__(path, rotate_bytes=rotate_bytes)
        self.fail_after = fail_after
        self.torn_bytes = torn_bytes
        self.fired = False
        self._n = 0
        self._torn_at: Optional[int] = None

    def append(self, record: dict) -> None:
        if self._torn_at is not None:
            # Emulate the post-crash reopen: the writer heals the torn tail
            # before its first new record (see request_log._heal_torn_tail).
            self._f.flush()
            os.truncate(self.path, self._torn_at)
            self._torn_at = None
        if not self.fired and self._n == self.fail_after:
            self.fired = True
            if self.torn_bytes is not None:
                line = json.dumps(record, separators=(",", ":"))
                k = max(1, min(self.torn_bytes, len(line) - 1))
                self._torn_at = os.path.getsize(self.path)
                self._f.write(line[:k])
                self._f.flush()
                os.fsync(self._f.fileno())
                raise InjectedFailure(
                    f"torn log append ({k} bytes) at record {self._n}"
                )
            super().append(record)
            raise InjectedFailure(
                f"process died after durable log append {self._n}"
            )
        self._n += 1
        super().append(record)


def _tear_checkpoint(step_dir: str, variant: int) -> str:
    """Apply one torn-write failure mode to a prepared checkpoint dir."""
    if variant % 3 == 0:
        os.remove(os.path.join(step_dir, "_COMMITTED"))
        return "missing _COMMITTED"
    if variant % 3 == 1:
        leaf = sorted(
            n for n in os.listdir(step_dir) if n.startswith("leaf_")
        )[variant % 2]
        os.truncate(os.path.join(step_dir, leaf), 17)
        return f"truncated {leaf}"
    with open(os.path.join(step_dir, "manifest.json"), "r+") as f:
        f.seek(0)
        f.write("{torn")
    return "corrupt manifest"


def chaos_sweep(
    *,
    model,
    prepared,
    requests: list[Request],
    workdir: str,
    batch: int = 2,
    max_seq: int = 32,
    points_per_seam: int = 5,
    seams: tuple = SEAMS,
    seed: int = 0,
    max_restarts: int = 8,
    device="cuda",
) -> dict:
    """Run every seeded kill point; returns the per-point report + summary.

    ``prepared`` is the serving tree (calibrated, for the int-LUT engines to
    be in the bit-exact domain).  The reference tokens come from one
    undisturbed :class:`ServeEngine` run; every fault's outcome records
    ``dropped`` (requests whose final token count misses their budget, or
    that were quarantined/shed — chaos faults must cause neither) and
    ``token_mismatches`` against the reference.  The summary is green iff
    both totals are zero across all ``len(seams) * points_per_seam`` points.
    """
    os.makedirs(workdir, exist_ok=True)
    ref_eng = ServeEngine(model, prepared, batch=batch, max_seq=max_seq, device=device)
    ref = ref_eng.generate(requests)
    # One host sync per admission wave: the reference run measures how many
    # waves this workload actually has, and every seeded kill position wraps
    # modulo it — so all points_per_seam points FIRE on any request mix
    # (a kill scheduled past the last wave would be a vacuously green point).
    n_waves = max(1, ref_eng.host_syncs)
    budgets = [r.max_new_tokens for r in requests]

    def policy():
        return RestartPolicy(
            retryable=(InjectedFailure,), max_restarts=max_restarts,
            backoff_s=0.0, seed=seed,
        )

    def engine_factory():
        return ServeEngine(model, prepared, batch=batch, max_seq=max_seq, device=device)

    def outcome(seam, point, server, outs, detail="", fired=True):
        dropped = sum(
            1 for i, toks in enumerate(outs) if len(toks) != budgets[i]
        ) + len(server.quarantined) + len(server.shed)
        mism = sum(1 for i, toks in enumerate(outs) if toks != ref[i])
        return {
            "seam": seam, "point": point, "detail": detail,
            "fired": bool(fired),        # did the kill actually land?
            "dropped": dropped, "token_mismatches": mism,
            "restarts": server.restarts, "rebuilds": server.rebuilds,
        }

    results = []
    for seam in seams:
        for j in range(points_per_seam):
            tag = f"{seam}_{j}"
            log_path = os.path.join(workdir, f"{tag}.jsonl")
            kw = j % n_waves                 # kill wave for this point
            if seam == "mid_wave":
                inj = FailureInjector(fail_at_waves=(kw,))
                srv = LiveServer(
                    engine_factory, log_path=log_path, policy=policy(),
                    injector=inj,
                )
                outs = srv.serve(requests)
                results.append(outcome(
                    seam, j, srv, outs, f"wave {kw}", fired=bool(inj.fired),
                ))

            elif seam == "mid_swap_stage":
                probe = engine_factory()
                ctrl = SwapController(probe)
                if j % 2 == 0:
                    def build():
                        raise InjectedFailure(f"stage died mid-build {j}")
                    detail = "stage raised"
                else:
                    build = lambda: None   # thread ends: no tree, no error
                    detail = "stage thread died silently"
                ctrl.last_staged = staged = StagedSwap(build)
                surfaced = False
                try:
                    ctrl.flip(staged, timeout=30.0)
                except RuntimeError:
                    surfaced = True
                st = ctrl.status()
                ok = surfaced and (
                    st["stage_error"] is not None or st["stage_dead"]
                )
                # The failed stage must not have perturbed serving: kill the
                # server mid-wave behind it and replay.
                inj = FailureInjector(fail_at_waves=(kw,))
                srv = LiveServer(
                    engine_factory, log_path=log_path, policy=policy(),
                    injector=inj,
                )
                outs = srv.serve(requests)
                out = outcome(seam, j, srv, outs, detail,
                              fired=surfaced and bool(inj.fired))
                if not ok:
                    out["dropped"] += 1      # silent stage failure = a drop
                    out["detail"] += " (NOT surfaced)"
                results.append(out)

            elif seam == "mid_ckpt_write":
                from repro_torch.ckpt import checkpoint as ckpt

                cdir = os.path.join(workdir, f"{tag}_ckpt")
                step_dir = ckpt.save_prepared(cdir, 0, prepared)
                detail = _tear_checkpoint(step_dir, seed + j)
                falls = {"n": 0}

                def factory():
                    try:
                        tree = ckpt.restore_prepared(cdir, 0, device=device)
                    except Exception:
                        falls["n"] += 1      # torn ckpt -> cold prepare
                        tree = prepared
                    return ServeEngine(
                        model, tree, batch=batch, max_seq=max_seq, device=device
                    )

                inj = FailureInjector(fail_at_waves=(kw,))
                srv = LiveServer(
                    factory, log_path=log_path, policy=policy(),
                    injector=inj,
                )
                outs = srv.serve(requests)
                shutil.rmtree(cdir)
                out = outcome(
                    seam, j, srv, outs,
                    f"{detail}; cold fallbacks {falls['n']}",
                    fired=falls["n"] > 0,
                )
                out["cold_fallbacks"] = falls["n"]
                if falls["n"] == 0:
                    out["dropped"] += 1      # torn ckpt restored "fine"?!
                    out["detail"] += " (torn checkpoint not detected)"
                results.append(out)

            elif seam == "mid_log_append":
                logs = []
                def mk_log(p, kw=kw):
                    cl = ChaosLog(p, fail_after=len(requests) + kw)
                    logs.append(cl)
                    return cl
                srv = LiveServer(
                    engine_factory, log_path=log_path, policy=policy(),
                    log_factory=mk_log,
                )
                outs = srv.serve(requests)
                results.append(outcome(
                    seam, j, srv, outs,
                    f"died after durable append {len(requests) + kw}",
                    fired=any(cl.fired for cl in logs),
                ))

            elif seam == "torn_tail":
                torn = 5 + 7 * ((seed + j) % 5)
                logs = []
                def mk_torn(p, kw=kw, torn=torn):
                    cl = ChaosLog(
                        p, fail_after=len(requests) + kw, torn_bytes=torn,
                    )
                    logs.append(cl)
                    return cl
                srv = LiveServer(
                    engine_factory, log_path=log_path, policy=policy(),
                    log_factory=mk_torn,
                )
                outs = srv.serve(requests)
                results.append(outcome(
                    seam, j, srv, outs,
                    f"torn {torn} bytes at append {len(requests) + kw}",
                    fired=any(cl.fired for cl in logs),
                ))
            else:
                raise ValueError(f"unknown chaos seam {seam!r}")

    return {
        "points": len(results),
        "seams": list(seams),
        "points_per_seam": points_per_seam,
        "dropped": sum(r["dropped"] for r in results),
        "token_mismatches": sum(r["token_mismatches"] for r in results),
        "restarts": sum(r["restarts"] for r in results),
        "cold_fallbacks": sum(r.get("cold_fallbacks", 0) for r in results),
        "results": results,
    }
