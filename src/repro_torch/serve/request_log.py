"""Durable append-only request/admission log for crash-recoverable serving
(the port's own copy of ``repro.serve.request_log``: pure Python and JSON,
no framework; the records carry no timestamps, so the same serve writes the
same bytes in either package, and either package's :func:`replay_state`
reads the other's logs).

One JSONL file records everything a restarted engine needs to resume
mid-stream: the submitted requests (prompt + budget), every admission wave's
``(request, slot)`` pairs, and — the payload that makes replay exact — the
tokens each wave emitted per request, written at the wave's single host sync
(:attr:`repro_torch.serve.serving.ServeEngine.on_wave`) *before* the engine's own
output bookkeeping.  A crash anywhere therefore loses at most tokens that
were never durably logged, and :func:`replay_state` reconstructs each
request's exact emitted prefix.

Recovery then leans on the teacher-forced replay identity the pad-masked
prefill guarantees (``tests/test_torch_serving.py`` / ``tests/test_torch_live_ops.py``):
prefilling ``prompt + emitted`` and decoding the remaining
``max_new - len(emitted)`` budget continues the greedy stream token-for-token
identically to the undisturbed run — so a kill-and-replay serve is
output-identical, not merely approximately resumed.

Write discipline: every record is one JSON line, flushed **and fsynced**
before ``append`` returns (the crash model is process death, so the tail
must be on disk, not in a userspace buffer).  A crash mid-``write`` can
still leave a torn final line; :func:`replay_state` tolerates exactly that —
an undecodable *tail* line is dropped (``torn_tail=True``), while corruption
anywhere earlier raises (that's disk damage, not a crash artifact).

Growth is bounded two ways for long-running serves:

* **size-triggered rotation** — when the active file reaches
  ``rotate_bytes`` the writer renames it to ``<path>.<n>`` and starts a
  fresh file; :func:`replay_state` folds every rotated segment (in order)
  plus the active file, and tolerates a torn tail only at the very end of
  the *active* file (rotated segments were complete when sealed — a torn
  line there is disk damage).
* **compaction** — :meth:`RequestLog.compact` folds the whole history and
  rewrites it as one record per request: completed requests' per-wave
  records collapse to a single ``hist`` record carrying their final tokens,
  in-flight requests keep their durable prefix the same way, and the
  wave/restart/swap counters are carried in a ``compact`` header.  Replay
  semantics are unchanged; only the per-wave history is gone.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


def _segment_paths(path: str) -> list[str]:
    """Rotated segments of ``path`` in write order (oldest first), excluding
    the active file itself."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    segs = []
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    segs.append((int(suffix), os.path.join(d, name)))
    return [p for _, p in sorted(segs)]


def _heal_torn_tail(path: str) -> bool:
    """Truncate a torn trailing line (no terminating newline) at ``path``.

    Returns True when bytes were removed.  Only the *writer* heals — readers
    (:func:`replay_state`) just skip the torn tail, so a read-only replay of
    a dead server's log never mutates it.
    """
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    if not data or data.endswith(b"\n"):
        return False
    cut = data.rfind(b"\n") + 1
    os.truncate(path, cut)
    return True


class RequestLog:
    """Append-only JSONL writer; every record is fsynced before return.

    ``rotate_bytes`` (optional) seals the active file into a numbered
    segment and starts a fresh one whenever the active file has reached
    that size *before* an append — no record ever spans two segments.
    """

    def __init__(self, path: str, *, rotate_bytes: Optional[int] = None):
        self.path = str(path)
        self.rotate_bytes = rotate_bytes
        self.rotations = 0
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # A crash mid-append leaves a torn final line with no newline; a
        # plain append-mode reopen would concatenate the NEXT record onto
        # that prefix, corrupting a line mid-file (which replay_state
        # rightly refuses).  The torn bytes were never a durable record, so
        # the writer truncates them at open.
        self.healed_torn_tail = _heal_torn_tail(self.path)
        self._f = open(self.path, "a", encoding="utf-8")

    def append(self, record: dict) -> None:
        if (
            self.rotate_bytes is not None
            and self._f.tell() >= self.rotate_bytes
        ):
            self._rotate()
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def _rotate(self) -> None:
        segs = _segment_paths(self.path)
        nxt = 1 + max(
            (int(p.rsplit(".", 1)[1]) for p in segs), default=0
        )
        self._f.close()
        os.rename(self.path, f"{self.path}.{nxt}")
        self._f = open(self.path, "a", encoding="utf-8")
        self.rotations += 1

    def compact(self) -> dict:
        """Rewrite the log (all segments) as one-record-per-request.

        Completed requests lose their per-wave records (the unbounded part);
        every request keeps its prompt/budget and durable emitted tokens, so
        replay, workload cross-checks and final results are unchanged.
        Returns ``{"before_bytes": ..., "after_bytes": ...}``.
        """
        state = replay_state(self.path)
        segs = _segment_paths(self.path)
        before = sum(
            os.path.getsize(p) for p in segs + [self.path]
            if os.path.exists(p)
        )
        self._f.close()
        tmp = self.path + ".compact.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            def w(rec):
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")

            w({"t": "compact", "waves": state.waves,
               "restarts": state.restarts, "swaps": state.swaps})
            for idx in sorted(state.requests):
                prompt, max_new = state.requests[idx]
                w({"t": "request", "i": idx, "prompt": prompt,
                   "max_new": max_new})
                toks = state.emitted.get(idx, [])
                if toks:
                    w({"t": "hist", "i": idx, "toks": toks})
                if idx in state.admitted:
                    w({"t": "admitted", "i": idx})
            for idx in sorted(state.quarantined):
                w({"t": "quarantine", "i": idx,
                   "reason": state.quarantine_reasons.get(idx, "")})
            for idx in sorted(state.shed):
                w({"t": "shed", "i": idx,
                   "reason": state.shed_reasons.get(idx, "")})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        for p in segs:
            os.remove(p)
        self._f = open(self.path, "a", encoding="utf-8")
        return {"before_bytes": before,
                "after_bytes": os.path.getsize(self.path)}

    # --- typed records ----------------------------------------------------

    def log_request(self, idx: int, prompt, max_new: int) -> None:
        self.append({"t": "request", "i": int(idx),
                     "prompt": [int(t) for t in prompt],
                     "max_new": int(max_new)})

    def log_wave(self, wave: int, admitted, emitted) -> None:
        """One admission wave: ``admitted`` is ``[(request_idx, slot)]``,
        ``emitted`` is ``[(request_idx, slot, tokens)]`` — request indices in
        the *log's* (global) numbering, not a single generate() call's."""
        self.append({
            "t": "wave", "wave": int(wave),
            "admit": [[int(i), int(s)] for i, s in admitted],
            "emit": [[int(i), int(s), [int(t) for t in toks]]
                     for i, s, toks in emitted],
        })

    def log_restart(self, attempt: int, reason: str = "") -> None:
        self.append({"t": "restart", "attempt": int(attempt),
                     "reason": str(reason)[:200]})

    def log_swap(self, wave: Optional[int]) -> None:
        self.append({"t": "swap",
                     "wave": None if wave is None else int(wave)})

    def log_quarantine(self, idx: int, reason: str = "") -> None:
        """A poison request was isolated: it is out of the replay set for
        good, reported to the caller — never silently dropped."""
        self.append({"t": "quarantine", "i": int(idx),
                     "reason": str(reason)[:200]})

    def log_shed(self, idx: int, reason: str = "deadline") -> None:
        """A request was load-shed (deadline exceeded) with its durable
        prefix intact."""
        self.append({"t": "shed", "i": int(idx), "reason": str(reason)[:200]})

    def log_giveup(self, reason: str = "") -> None:
        """The supervisor exhausted its budget/deadline; the log is the
        surviving source of truth for a successor server."""
        self.append({"t": "giveup", "reason": str(reason)[:200]})

    def close(self) -> None:
        self._f.close()


@dataclasses.dataclass
class ReplayState:
    """What the log proves happened — the restart's resume point."""

    requests: dict[int, tuple[list[int], int]]   # idx -> (prompt, max_new)
    emitted: dict[int, list[int]]                # idx -> durable tokens so far
    waves: int = 0                               # wave records seen
    restarts: int = 0                            # restart records seen
    swaps: int = 0                               # swap records seen
    giveups: int = 0                             # giveup records seen
    torn_tail: bool = False                      # final line was torn
    admitted: set = dataclasses.field(default_factory=set)
    quarantined: set = dataclasses.field(default_factory=set)
    shed: set = dataclasses.field(default_factory=set)
    quarantine_reasons: dict = dataclasses.field(default_factory=dict)
    shed_reasons: dict = dataclasses.field(default_factory=dict)

    def remaining(self, idx: int) -> int:
        _prompt, max_new = self.requests[idx]
        return max_new - len(self.emitted.get(idx, []))

    def pending(self) -> list[tuple[int, list[int], int]]:
        """Requests not yet complete — and not quarantined or shed — as
        ``(idx, resume_prompt, budget)``: prefill ``prompt + emitted`` and
        decode the remaining budget — the teacher-forced continuation that
        is token-identical to never having crashed."""
        out = []
        for idx in sorted(self.requests):
            if idx in self.quarantined or idx in self.shed:
                continue
            rem = self.remaining(idx)
            if rem > 0:
                prompt, _ = self.requests[idx]
                out.append((idx, prompt + self.emitted.get(idx, []), rem))
        return out

    def completed(self) -> dict[int, list[int]]:
        return {
            idx: self.emitted.get(idx, [])
            for idx in self.requests if self.remaining(idx) == 0
        }

    def inflight(self) -> list[int]:
        """Requests that were admitted to a wave and are still incomplete —
        the crash-attribution suspect pool (quarantined/shed excluded)."""
        return [
            idx for idx, _rp, _rem in self.pending() if idx in self.admitted
        ]


def _fold(state: ReplayState, rec: dict) -> None:
    t = rec.get("t")
    if t == "request":
        state.requests[rec["i"]] = (list(rec["prompt"]), rec["max_new"])
    elif t == "wave":
        state.waves += 1
        for i, _slot in rec["admit"]:
            state.admitted.add(i)
        for i, _slot, toks in rec["emit"]:
            state.admitted.add(i)
            state.emitted.setdefault(i, []).extend(toks)
    elif t == "hist":                      # compaction summary record
        state.emitted.setdefault(rec["i"], []).extend(rec["toks"])
    elif t == "admitted":                  # compaction admission marker
        state.admitted.add(rec["i"])
    elif t == "compact":
        state.waves += rec.get("waves", 0)
        state.restarts += rec.get("restarts", 0)
        state.swaps += rec.get("swaps", 0)
    elif t == "restart":
        state.restarts += 1
    elif t == "swap":
        state.swaps += 1
    elif t == "quarantine":
        state.quarantined.add(rec["i"])
        state.quarantine_reasons[rec["i"]] = rec.get("reason", "")
    elif t == "shed":
        state.shed.add(rec["i"])
        state.shed_reasons[rec["i"]] = rec.get("reason", "")
    elif t == "giveup":
        state.giveups += 1


def replay_state(path: str) -> ReplayState:
    """Fold a (possibly torn-tailed, possibly rotated) log into a
    :class:`ReplayState`.

    Missing file == empty state (a fresh serve).  An undecodable final line
    of the *active* file is a crash artifact and is dropped; an undecodable
    line anywhere else — earlier in the active file or inside a sealed
    rotated segment — raises.
    """
    state = ReplayState(requests={}, emitted={})
    path = str(path)
    files = _segment_paths(path)
    if os.path.exists(path):
        files = files + [path]
    elif not files:
        return state
    for fi, fpath in enumerate(files):
        with open(fpath, "r", encoding="utf-8") as f:
            raw = f.read()
        lines = [ln for ln in raw.split("\n") if ln.strip()]
        for li, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if fi == len(files) - 1 and li == len(lines) - 1:
                    state.torn_tail = True
                    break
                raise ValueError(
                    f"{fpath}: corrupt record at line {li + 1} (not the "
                    f"active tail; this is not a torn-write artifact)"
                )
            _fold(state, rec)
    return state
