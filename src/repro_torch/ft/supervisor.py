"""Fault-tolerant supervision: the restart discipline of the port's serving
(counterpart of ``repro.ft.supervisor``).

* **generic supervision** — :func:`supervise` runs any restartable body under
  a :class:`RestartPolicy`: a configurable *retryable* exception set (crashes
  worth restarting for), exponential backoff with deterministic jitter
  between attempts, a restart budget and a wall-clock deadline.
  Non-retryable exceptions propagate immediately; exhausting the budget
  re-raises the **original** failure (the one that started the restart
  storm), chaining the last attempt's failure as its ``__cause__``.
* **supervised serving** — :class:`repro_torch.serve.ops.LiveServer` wraps
  the continuous-batching serve loop in :func:`supervise`; a killed engine
  replays its in-flight slots from the durable request log (token-identical
  recovery, see ``serve/ops.py``).
* **failure injection** — :class:`FailureInjector` raises at configured serve
  *waves* (mid-decode, between two admission waves' host syncs), train
  *steps*, or whenever a *poison* request emits.

Not yet ported: ``SupervisorConfig`` / ``run_supervised`` (checkpoint/restart
training), which restore the training state through ``jax.eval_shape``; they
come with the training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from repro_torch import timing


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises InjectedFailure the first time each configured point is reached.

    ``fail_at_steps`` fires from the training loop (``maybe_fail``);
    ``fail_at_waves`` fires from *inside serving* (``maybe_fail_wave``), at
    the admission-wave granularity the continuous scheduler exposes — i.e.
    mid-decode, after some requests' tokens are already emitted and logged,
    with other slots still in flight.

    ``poison_requests`` models a *poison request*: unlike the fire-once
    points above, it raises **every** time one of the named global request
    indices emits in a wave (``maybe_fail_requests``) — a deterministic
    replay-crasher, the adversary the LiveServer quarantine bisector exists
    for.
    """

    fail_at_steps: tuple = ()
    fail_at_waves: tuple = ()
    poison_requests: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and ("step", step) not in self.fired:
            self.fired.add(("step", step))
            raise InjectedFailure(f"injected failure at step {step}")

    def maybe_fail_wave(self, wave: int):
        if wave in self.fail_at_waves and ("wave", wave) not in self.fired:
            self.fired.add(("wave", wave))
            raise InjectedFailure(f"injected failure at serve wave {wave}")

    def maybe_fail_requests(self, global_idxs):
        for idx in global_idxs:
            if idx in self.poison_requests:
                raise InjectedFailure(f"poison request {idx}")


@dataclasses.dataclass
class RestartPolicy:
    """What to restart for, how often, and how fast.

    ``retryable`` is the exception allowlist — anything else propagates
    immediately (a shape error or OOM loops forever if you restart it).
    Backoff is exponential (``backoff_s * backoff_factor**attempt``, capped
    at ``max_backoff_s``) with multiplicative jitter in
    ``[1, 1 + jitter_frac]`` drawn from a seeded RNG, so a fleet of
    restarting workers de-synchronizes deterministically in tests.

    ``deadline_s`` bounds total wall clock across ALL attempts: once the
    supervised run has been alive that long, the next retryable failure
    gives up even if restart attempts remain — an SLO guard against a slow
    crash-loop that burns hours inside its nominal restart budget.
    """

    retryable: tuple = (InjectedFailure,)
    max_restarts: int = 8
    backoff_s: float = 0.0                # 0 -> restart immediately
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0
    jitter_frac: float = 0.1
    seed: int = 0
    deadline_s: Optional[float] = None    # total wall-clock giveup

    def delay_s(self, restart_idx: int, rng: random.Random) -> float:
        """Sleep before restart ``restart_idx`` (1-based)."""
        if self.backoff_s <= 0:
            return 0.0
        base = min(
            self.backoff_s * self.backoff_factor ** (restart_idx - 1),
            self.max_backoff_s,
        )
        return base * (1.0 + self.jitter_frac * rng.random())


def supervise(
    body: Callable[[int], object],
    *,
    policy: Optional[RestartPolicy] = None,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    on_giveup: Optional[Callable[[BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = timing.clock,
):
    """Run ``body(attempt)`` under the restart policy; returns
    ``(result, restarts)``.

    ``body`` is called with the attempt index (0 on the first run, then the
    restart count); it must be restartable — i.e. recover its own progress
    from durable state (checkpoints, the serving request log).  Retryable
    failures trigger a backoff + retry; the first failure is remembered and
    re-raised when ``max_restarts`` is exhausted OR ``policy.deadline_s``
    of wall clock has elapsed (with the final attempt's failure chained as
    ``__cause__``).  ``on_giveup(original_failure)`` fires right before
    that re-raise — the hook callers use to flush durable state (e.g. the
    serving request log) while the process is still intact.  Non-retryable
    failures propagate immediately, without the hook.  ``clock`` is
    injectable for deterministic deadline tests and defaults to the
    process-wide :func:`repro_torch.timing.clock`, so ``timing.override_clock``
    steers supervision deadlines and trace timestamps from one place.
    """
    policy = policy or RestartPolicy()
    rng = random.Random(policy.seed)
    t0 = clock()
    first_failure: Optional[BaseException] = None
    restarts = 0
    while True:
        try:
            result = body(restarts)
        except policy.retryable as e:
            if first_failure is None:
                first_failure = e
            restarts += 1
            out_of_time = (
                policy.deadline_s is not None
                and clock() - t0 >= policy.deadline_s
            )
            if restarts > policy.max_restarts or out_of_time:
                if on_giveup is not None:
                    on_giveup(first_failure)
                if first_failure is e:
                    raise
                raise first_failure from e
            if on_restart is not None:
                on_restart(restarts, e)
            delay = policy.delay_s(restarts, rng)
            if delay > 0:
                sleep(delay)
        else:
            # A failure's traceback holds this frame, and the frame holds the
            # failure: left set, the pair is a reference cycle that keeps
            # ``body``'s closure (a server, its engine, its tree) alive until
            # the garbage collector runs.
            first_failure = None
            return result, restarts
