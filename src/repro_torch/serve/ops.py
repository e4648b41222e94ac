"""Live operations for the port's serving engine: hot-swap + supervised
recovery (counterpart of ``repro.serve.ops``).

The deployment half of the paper's capacity-computation tradeoff: once a
model serves traffic, its LUT plan is re-tuned, its weights are refreshed,
and its hosts die — none of which may drop a request or change a token the
numerics contract says is fixed.  Two objects wrap
:class:`repro_torch.serve.serving.ServeEngine` for this:

* :class:`SwapController` — **double-buffered plan/weight hot-swap**.
  ``stage()`` builds the replacement :class:`repro_torch.core.PreparedLinear` tree
  on a background thread (re-preparing raw weights, optionally under a new
  :class:`repro_torch.tune.ModelPlan`) while the engine keeps decoding on the
  active tree; ``flip()`` hands the staged tree to
  :meth:`ServeEngine.request_swap`, which installs it atomically at the next
  admission-wave boundary — zero dropped requests, and a numerics-identical
  swap (same weights, different plan/packing inside one numerics family) is
  token-invisible.  Fingerprint-incompatible trees are refused at flip time
  with the per-layer drift diagnostic; a failed (or silently dead) stage
  raises at ``flip()`` and leaves the active tree untouched.
  :meth:`SwapController.status` is the operator probe: staging / ready /
  failed / dead, plus whether a flip is parked at the engine.

* :class:`LiveServer` — **supervised serving with request-level fault
  domains**.  Wraps the serve loop in :func:`repro_torch.ft.supervisor.supervise`;
  every admission wave's tokens are durably logged
  (:mod:`repro_torch.serve.request_log`) at the wave's host sync, and a restarted
  attempt rebuilds the engine (cold prepare or
  :func:`repro_torch.ckpt.checkpoint.restore_prepared` fast start) and resumes
  each in-flight slot by teacher-forced replay.  On top of whole-process
  recovery it isolates *request-level* faults so one bad request cannot burn
  the whole restart budget:

  - **poison quarantine** — repeated identical crashes trigger a
    crash-attribution bisector: the suspect pool is the intersection of the
    in-flight sets across identical crashes, narrowed by serving probe
    subsets across restarts until a single request is attributed and
    durably quarantined.  Quarantined requests are *reported* (partial
    tokens + reason), never silently dropped, and the survivors complete
    token-identically.
  - **per-request retry budgets** — ``Request.max_retries`` (or the server
    default) bounds how many crashes a request may be in flight for before
    it is quarantined outright: the blunt fallback when attribution is not
    worth more restarts.
  - **bounded admission + load shedding** — :meth:`LiveServer.submit`
    refuses work past ``queue_limit`` (backpressure, not buffering);
    requests with a ``deadline_s`` still unfinished that many seconds into
    the serve are shed at the next restart boundary, durably logged, and
    reported with whatever prefix they emitted.

**Replay-exactness domain.**  Token-identical recovery needs numerics that
are *batch-composition invariant* (a request's logits independent of which
requests share its batch — a restart re-buckets the surviving slots).
Dense, ``dequant`` and ``pallas``-tier float paths are invariant per-row;
the int-LUT engines quantize activations with a dynamic per-**tensor**
scale (:func:`repro_torch.core.api.quantized_lut_gemm`), which historically left
them *faithful-greedy* under restart rather than bit-identical.  With a
frozen activation calibration (``Model.prepare(params, calibrate=batch)``,
:mod:`repro_torch.core.calibrate`) the quantizer scale is a static per-layer
constant, so **every servable engine — dequant, lut, stream, pallas tiers —
replays bit-exactly** across kill/restart re-bucketing and across hot-swap;
the calibration is part of the swap-compatibility fingerprint, so a flip
that would change it is refused.  Uncalibrated int-LUT trees keep the old
dynamic-scale caveat.  (Recurrent M/R/S units additionally consume pad
through state — same caveat as the pad-mask invariance contract in
``serve/serving.py``.)

**Streams.**  In the port a staged tree is built on a CUDA stream of its
own, by a thread that makes the card current first; the stage records an
event when it ends, and the serving stream waits on that event at the flip
(:meth:`repro_torch.serve.serving.ServeEngine._poll_swap`), so the serving
thread never syncs for a swap.  Before each restart the server drops the
failed attempt's engine and clears the frames of its failure, so the old
tree and caches are freed before ``engine_factory`` builds the next.
"""

from __future__ import annotations

import dataclasses
import threading
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import timing
from repro_torch.ft.supervisor import RestartPolicy, supervise
from repro_torch.serve.request_log import RequestLog, replay_state
from repro_torch.serve.serving import Request, ServeEngine


# ---------------------------------------------------------------------------
# Hot-swap: background stage + wave-boundary flip
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SwapReport:
    """What a completed flip cost: ``stage_seconds`` of background prepare
    (overlapped with serving — not on the decode path; on a card, until the
    stage's device work finished), ``flip_wait_seconds`` from the flip
    request to the wave-boundary install (the only serving-visible latency),
    and where it landed."""

    stage_seconds: float
    flip_wait_seconds: float
    wave: Optional[int]
    swaps: int


class StagedSwap:
    """Handle for a background ``stage()``: join it, read its tree/timing.

    On a CUDA ``device`` the build runs on a stream of its own, ordered after
    the work the caller had enqueued when the stage started; ``ready`` is the
    event recorded on that stream when the build ends (the flip's serving
    stream waits on it).  ``obs`` gets the ``swap stage`` span, recorded
    from the stage's thread when the build (on a card, its device work) has
    finished."""

    def __init__(self, build: Callable[[], object], *, device=None, obs=None):
        self.tree = None
        self.error: Optional[BaseException] = None
        self.stage_seconds = 0.0
        self.ready: Optional[torch.cuda.Event] = None
        dev = None if device is None else torch.device(device)
        after = None
        if dev is not None and dev.type == "cuda":
            after = torch.cuda.Event()
            after.record(torch.cuda.current_stream(dev))

        def run():
            t0 = timing.clock()
            try:
                if after is None:
                    tree = build()
                else:
                    torch.cuda.set_device(dev)
                    stream = torch.cuda.Stream(dev)
                    stream.wait_event(after)
                    with torch.cuda.stream(stream):
                        tree = build()
                    done = torch.cuda.Event()
                    done.record(stream)
                    done.synchronize()          # this thread waits, not the serving one
                    self.ready = done
                self.tree = tree
            except BaseException as e:  # surfaced on wait(), not swallowed
                self.error = e
            finally:
                t1 = timing.clock()
                self.stage_seconds = t1 - t0
                if obs is not None:     # the tracer's append is atomic under the GIL
                    obs.ops_span("swap stage", t0, t1, actor="swap",
                                 ok=self.error is None and self.tree is not None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    @property
    def dead(self) -> bool:
        """Thread finished without a tree AND without a recorded error —
        i.e. it died out-of-band (killed mid-build).  A silent no-op swap is
        worse than a loud one, so ``wait()`` turns this into an exception."""
        return not self._thread.is_alive() and self.tree is None and self.error is None

    def wait(self, timeout: Optional[float] = None):
        """Block until the stage finishes; returns the staged tree or
        re-raises the build failure (the active tree is untouched either
        way — staging is entirely off to the side)."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("staged swap still building")
        if self.error is not None:
            raise RuntimeError("hot-swap stage failed; active tree untouched") from self.error
        if self.tree is None:
            raise RuntimeError(
                "hot-swap stage thread died without producing a tree or an "
                "error (killed mid-build?); active tree untouched"
            )
        return self.tree


class SwapController:
    """Double-buffered parameter swaps against a live :class:`ServeEngine`.
    ``obs`` (default: the engine's) gets the stage and flip spans and a
    refused swap's event on the ``swap`` track."""

    def __init__(self, engine: ServeEngine, *, obs=None):
        self.engine = engine
        self.obs = obs if obs is not None else engine.obs
        self.last_staged: Optional[StagedSwap] = None

    def stage(self, *, params=None, qparams=None, plan=None,
              prepare_kw: Optional[dict] = None) -> StagedSwap:
        """Start building the replacement tree on a background thread (on a
        card, on a stream of its own).

        Exactly one source: ``params`` (an already-built tree, staged as-is)
        or ``qparams`` (a raw quantized tree, prepared via
        ``engine.model.prepare`` — under ``plan`` when given, i.e. a re-tune
        swap).  Decode continues on the active tree throughout.
        """
        if (params is None) == (qparams is None):
            raise ValueError("stage() needs exactly one of params=/qparams=")
        if params is not None:
            build = lambda: params
        else:
            kw = dict(n_hint=self.engine.batch)
            kw.update(prepare_kw or {})
            build = lambda: self.engine.model.prepare(qparams, plan=plan, **kw)
        staged = StagedSwap(build, device=self.engine.device, obs=self.obs)
        self.last_staged = staged
        return staged

    def flip(self, staged: StagedSwap, *, check: bool = True,
             wait: bool = True, timeout: float = 120.0) -> SwapReport:
        """Install a staged tree at the next admission-wave boundary.

        Joins the stage, hands the tree to ``request_swap`` (which refuses
        fingerprint/dense drift when ``check``), then — when ``wait`` —
        blocks until the serving thread reports the flip applied.  Returns
        the :class:`SwapReport`; raises without touching the active tree if
        the stage failed, died, or the swap is refused.
        """
        tree = staged.wait(timeout)
        applied = threading.Event()
        t0 = timing.clock()
        try:
            self.engine.request_swap(tree, check=check, on_applied=applied.set,
                                     ready=staged.ready)
        except Exception as e:
            if self.obs is not None:     # fingerprint / drift refusal
                self.obs.ops_event("swap refuse", actor="swap", error=type(e).__name__)
            raise
        if wait and not applied.wait(timeout):
            raise TimeoutError(f"hot-swap staged but not applied within {timeout}s "
                               f"(engine stalled?)")
        t1 = timing.clock()
        if self.obs is not None:
            self.obs.ops_span("swap flip", t0, t1, actor="swap",
                              wave=self.engine.last_swap_wave, swaps=self.engine.swaps)
        return SwapReport(
            stage_seconds=staged.stage_seconds,
            flip_wait_seconds=t1 - t0,
            wave=self.engine.last_swap_wave,
            swaps=self.engine.swaps,
        )

    def status(self) -> dict:
        """Operator probe for the swap pipeline — answers "why hasn't my
        swap landed?" without joining anything: is a stage still building,
        ready, failed (with the error), or silently dead; is a flipped tree
        parked at the engine waiting for a wave boundary; how many swaps
        have landed and where the last one did."""
        s = self.last_staged
        with self.engine._swap_lock:
            flip_pending = self.engine._swap_pending is not None
        return {
            "staging": bool(s is not None and s.running),
            "staged_ready": bool(s is not None and not s.running
                                 and s.error is None and s.tree is not None),
            "stage_error": None if s is None or s.error is None else repr(s.error),
            "stage_dead": bool(s is not None and s.dead),
            "flip_pending": flip_pending,
            "swaps": self.engine.swaps,
            "last_swap_wave": self.engine.last_swap_wave,
        }


# ---------------------------------------------------------------------------
# Supervised serving: durable log + slot replay + request fault domains
# ---------------------------------------------------------------------------


class _BisectionStep(RuntimeError):
    """Control-flow 'failure': forces a supervised restart so the next
    attempt serves a different probe subset during poison attribution.  Added
    to the retryable set internally; never counts as a crash signature."""


class LiveServer:
    """Crash-recoverable serve: ``supervise``d engine + request-log replay.

    ``engine_factory()`` builds a fresh :class:`ServeEngine` per attempt —
    exactly what a restarted process would do (cold quantize+prepare, or the
    fast path: ``restore_prepared`` from a prepared checkpoint).  Each
    attempt reads the log's :func:`replay_state`, re-submits only the
    unfinished remainder of every request (teacher-forced: prompt + durable
    emitted prefix, remaining budget), and logs each new wave before the
    engine's own bookkeeping — so the injected/real crash window between
    "tokens computed" and "tokens returned" loses nothing and duplicates
    nothing.

    **Poison attribution.**  When consecutive attempts die with an
    *identical* crash signature ``(type, message)``, the server assumes a
    deterministic poison request and bisects: the suspect pool is the
    intersection of the in-flight sets across the identical crashes; while
    the pool holds more than one request, the next attempt serves only half
    of it (a *probe*) — a crash keeps the poison inside the probe, a clean
    probe completion moves its requests out of suspicion (their tokens are
    durable, so nothing is wasted).  A singleton pool is durably quarantined
    (``log_quarantine``) and excluded from replay; its partial tokens and
    reason are reported via :attr:`quarantined`.  Each bisection restart
    consumes one supervised restart, so attribution of one poison among
    ``n`` suspects costs about ``2 + log2(n)`` of the restart budget.

    ``injector.maybe_fail_requests`` (poison simulation) fires *before* the
    wave's log write — a poison request kills the wave mid-compute, so it
    never makes durable progress; ``maybe_fail_wave`` fires *after* it (the
    crash lands with that wave durable), at per-attempt wave numbering.

    ``clock`` is injectable (deadline shedding and the supervisor's
    wall-clock giveup share it) for deterministic tests; it defaults to the
    process-wide :func:`repro_torch.timing.clock`, so
    ``timing.override_clock`` steers the server, the supervisor and every
    trace timestamp together.

    ``obs`` threads a :class:`repro_torch.obs.Observer` through the server
    and every engine the factory builds (engines built without their own
    observer inherit it); restart / quarantine / shed / giveup / replay land
    as ``ops`` events on the ``supervisor`` track.  ``trace_path`` makes the
    server export the Perfetto trace atomically at every attempt's start and
    at completion: a kill mid-attempt leaves the previous complete export,
    never a torn file.

    Each attempt drops the previous attempt's engine before it calls
    ``engine_factory()``, and each restart clears the frames of the failure
    that caused it: the old tree and its caches are freed first, so a card
    holds one serving tree at a time (plus what the factory keeps).
    """

    def __init__(
        self,
        engine_factory: Callable[[], ServeEngine],
        *,
        log_path: str,
        policy: Optional[RestartPolicy] = None,
        injector=None,
        on_restart: Optional[Callable[[int, BaseException], None]] = None,
        log_factory: Optional[Callable[[str], RequestLog]] = None,
        rotate_bytes: Optional[int] = None,
        queue_limit: Optional[int] = None,
        max_request_retries: Optional[int] = None,
        clock: Callable[[], float] = timing.clock,
        obs=None,
        trace_path: Optional[str] = None,
    ):
        self.engine_factory = engine_factory
        self.log_path = str(log_path)
        self.policy = policy or RestartPolicy()
        self.injector = injector
        self._user_on_restart = on_restart
        self.log_factory = log_factory
        self.rotate_bytes = rotate_bytes
        self.queue_limit = queue_limit
        self.max_request_retries = max_request_retries
        self.clock = clock
        self.obs = obs
        self.trace_path = None if trace_path is None else str(trace_path)
        self.engine: Optional[ServeEngine] = None
        self.restarts = 0
        self.rebuilds = 0               # engine_factory invocations
        self.quarantined: dict[int, str] = {}   # idx -> reason, last serve
        self.shed: dict[int, str] = {}          # idx -> reason, last serve
        # bounded admission queue (submit/drain API)
        self._submitted: list[Request] = []
        self._drained = 0
        # poison-attribution state (reset per serve)
        self._last_sig: Optional[tuple] = None
        self._ident = 0
        self._pool: set = set()
        self._probe: Optional[set] = None

    def _export_trace(self) -> None:
        """Atomic Perfetto export (tmp + rename), at attempt starts and at
        completion, so a kill anywhere leaves a loadable trace."""
        if self.obs is None or self.trace_path is None:
            return
        from repro_torch.obs.export import write_perfetto

        write_perfetto(self.obs, self.trace_path)

    def _ops(self, name: str, **args) -> None:
        if self.obs is not None:
            self.obs.ops_event(name, actor="supervisor", **args)

    # --- bounded admission queue ------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request for the next :meth:`drain`.  Returns ``False`` —
        backpressure, nothing buffered — once ``queue_limit`` requests are
        already queued and undrained; the caller owns the retry policy."""
        if (
            self.queue_limit is not None
            and len(self._submitted) - self._drained >= self.queue_limit
        ):
            return False
        self._submitted.append(request)
        return True

    def drain(self) -> list[list[int]]:
        """Serve everything submitted so far (across all drains — the
        durable log keeps earlier batches' results and skips their work);
        returns per-request tokens in submission order."""
        self._drained = len(self._submitted)
        return self.serve(list(self._submitted))

    # --- supervised serve --------------------------------------------------

    def serve(self, requests: list[Request]) -> list[list[int]]:
        """Serve ``requests`` to completion across any number of restarts;
        returns per-request tokens in order — token-identical to an
        undisturbed run for every request that is neither quarantined nor
        shed (those are reported with their durable partial prefix, and
        named in :attr:`quarantined` / :attr:`shed`).  A pre-existing log at
        ``log_path`` resumes a previous process's work (prompts are
        cross-checked)."""
        t0 = self.clock()
        if self.log_factory is not None:
            log = self.log_factory(self.log_path)
        else:
            log = RequestLog(self.log_path, rotate_bytes=self.rotate_bytes)
        retryable = tuple(self.policy.retryable)
        policy = dataclasses.replace(
            self.policy, retryable=retryable + (_BisectionStep,)
        )
        self._last_sig, self._ident = None, 0
        self._pool, self._probe = set(), None
        self.quarantined, self.shed = {}, {}
        budgets = {
            i: (r.max_retries if r.max_retries is not None
                else self.max_request_retries)
            for i, r in enumerate(requests)
        }
        charges: dict[int, int] = {}
        try:
            prior = replay_state(self.log_path)
            for i, r in enumerate(requests):
                want = [int(t) for t in r.prompt]
                if i in prior.requests:
                    logged_prompt, logged_max = prior.requests[i]
                    if logged_prompt != want or logged_max != r.max_new_tokens:
                        raise ValueError(
                            f"request {i} does not match the durable log at "
                            f"{self.log_path}; refusing to replay a "
                            f"different workload over it"
                        )
                else:
                    log.log_request(i, want, r.max_new_tokens)

            def shed_overdue(state):
                for i, r in enumerate(requests):
                    if r.deadline_s is None:
                        continue
                    if i in state.shed or i in state.quarantined:
                        continue
                    if state.remaining(i) <= 0:
                        continue
                    if self.clock() - t0 >= r.deadline_s:
                        log.log_shed(
                            i, f"deadline {r.deadline_s}s exceeded"
                        )
                        state.shed.add(i)
                        state.shed_reasons[i] = f"deadline {r.deadline_s}s exceeded"
                        self._ops("shed", request=i, deadline_s=r.deadline_s)

            def body(attempt: int):
                state = replay_state(self.log_path)
                shed_overdue(state)
                pend = state.pending()
                if self._probe is not None:
                    pend = [p for p in pend if p[0] in self._probe]
                # The previous attempt's engine (its tree, its caches) goes
                # before the factory builds the next one.
                self.engine = None
                engine = self.engine_factory()
                if self.obs is not None and engine.obs is None:
                    engine.obs = self.obs     # factory-built engines inherit
                self.engine = engine
                self.rebuilds += 1
                self._ops("replay", attempt=attempt, pending=len(pend),
                          probe=sorted(self._probe) if self._probe else None)
                # Attempt boundary: flush what we have, so a kill during this
                # attempt still leaves a complete, loadable trace on disk.
                self._export_trace()
                results = {i: list(t) for i, t in state.emitted.items()}
                gmap = [idx for idx, _, _ in pend]
                rem = {idx: b for idx, _, b in pend}
                inflight: set = set()

                def on_wave(rec):
                    g_adm = [(gmap[i], s) for i, s in rec.admitted]
                    g_emit = [(gmap[i], s, toks) for i, s, toks in rec.emitted]
                    for gi, _s in g_adm:
                        inflight.add(gi)
                    if self.injector is not None:
                        # Poison fires BEFORE the log write: a poison
                        # request kills the wave during compute, so its
                        # tokens never become durable and it makes no
                        # progress across restarts — the deterministic
                        # replay-crasher the bisector exists for.
                        self.injector.maybe_fail_requests(
                            [gi for gi, _s, _t in g_emit]
                        )
                    log.log_wave(rec.wave, g_adm, g_emit)
                    if self.injector is not None:
                        # After the log write: a crash here lands with this
                        # wave durable (replay resumes past it).
                        self.injector.maybe_fail_wave(rec.wave)
                    for gi, _s, toks in g_emit:
                        rem[gi] -= len(toks)
                        if rem[gi] <= 0:
                            inflight.discard(gi)

                engine.on_wave = on_wave
                if pend:
                    reqs = [
                        Request(prompt=np.asarray(p, np.int32),
                                max_new_tokens=b)
                        for _idx, p, b in pend
                    ]
                    try:
                        outs = engine.generate(reqs)
                    except retryable as e:
                        self._note_crash(e, set(inflight), charges,
                                         budgets, log)
                        raise
                    for k, idx in enumerate(gmap):
                        results.setdefault(idx, []).extend(outs[k])
                if self._probe is not None:
                    # The probe subset completed clean: the poison is in the
                    # complement.  Its tokens are durable — nothing re-runs.
                    self._pool -= self._probe
                    self._advance_bisection(log)
                    raise _BisectionStep("probe subset completed clean")
                final = replay_state(self.log_path)
                self.quarantined = dict(final.quarantine_reasons)
                self.shed = dict(final.shed_reasons)
                return [results.get(i, []) for i in range(len(requests))]

            def on_restart(attempt: int, exc: BaseException):
                log.log_restart(attempt, repr(exc))
                self._ops("restart", attempt=attempt, error=type(exc).__name__)
                # The failed attempt's frames hold its engine and caches;
                # the exception is kept (the supervisor may re-raise it),
                # its locals are not.
                traceback.clear_frames(exc.__traceback__)
                if self._user_on_restart is not None:
                    self._user_on_restart(attempt, exc)

            def on_giveup(first: BaseException):
                # Flush the terminal verdict while the process still can:
                # a successor server reads it from the log.
                log.log_giveup(repr(first))
                self._ops("giveup", error=type(first).__name__)
                self._export_trace()

            result, self.restarts = supervise(
                body, policy=policy, on_restart=on_restart,
                on_giveup=on_giveup, clock=self.clock,
            )
            return result
        finally:
            # The engine's hook closes over this server: left set, the pair
            # is a reference cycle that keeps the engine's tree alive until
            # the garbage collector runs.
            if self.engine is not None:
                self.engine.on_wave = None
            log.close()
            self._export_trace()

    # --- poison attribution -----------------------------------------------

    def _note_crash(self, exc, inflight, charges, budgets, log) -> None:
        """Bookkeeping at a retryable crash, before it propagates to the
        supervisor: charge per-request retry budgets, fold the identical-
        signature suspect pool, and advance the bisection if warranted."""
        budget_hits = []
        for gi in sorted(inflight):
            charges[gi] = charges.get(gi, 0) + 1
            b = budgets.get(gi)
            if b is not None and charges[gi] > b and gi not in self.quarantined:
                reason = (f"retry budget exhausted: in flight for "
                          f"{charges[gi]} crashes (> {b} allowed)")
                log.log_quarantine(gi, reason)
                self.quarantined[gi] = reason
                budget_hits.append(gi)
                self._ops("quarantine", request=gi, kind="retry_budget")
        if budget_hits:
            # The blunt path just isolated suspect(s) the identical-crash
            # chain was built on; attributing the pool's remainder would
            # blame a bystander.  Restart the evidence chain — if the
            # poison is still loose, the next crashes rebuild it cleanly.
            self._last_sig, self._ident = None, 0
            self._pool, self._probe = set(), None
            return
        sig = (type(exc).__name__, str(exc))
        if sig == self._last_sig:
            self._ident += 1
            narrowed = self._pool & inflight
            self._pool = narrowed if narrowed else set(inflight)
        else:
            self._last_sig = sig
            self._ident = 1
            self._pool = set(inflight)
            self._probe = None
        if self._ident >= 2:
            self._advance_bisection(log)

    def _advance_bisection(self, log) -> None:
        pool = {gi for gi in self._pool if gi not in self.quarantined}
        if len(pool) == 1:
            gi = next(iter(pool))
            reason = (
                f"poison request: attributed after {self._ident} identical "
                f"crashes ({self._last_sig[0]}: {self._last_sig[1][:120]})"
            )
            log.log_quarantine(gi, reason)
            self.quarantined[gi] = reason
            self._ops("quarantine", request=gi, kind="poison_attributed")
            self._probe = None
            self._pool = set()
            self._last_sig, self._ident = None, 0
        elif len(pool) > 1:
            self._pool = pool
            self._probe = set(sorted(pool)[: len(pool) // 2])
        else:
            self._probe = None
