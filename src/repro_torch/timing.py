"""The one timing methodology of the port (counterpart of ``repro.timing``).

Monotonic clock, explicit warmup calls, device work finished inside the timed
region (``torch.cuda.synchronize`` when an output lives on a CUDA device),
median-of-k against scheduler noise.

**The clock is injectable.**  :func:`clock` is the single monotonic time
source every runtime component reads; tests replace it process-wide with
:func:`override_clock`.
"""

from __future__ import annotations

import contextlib
import time

import torch

# The process-wide monotonic time source (seconds).  Read through clock();
# replaced only via set_clock/override_clock.
_CLOCK = time.perf_counter


def clock() -> float:
    """Current monotonic time in seconds from the injectable source."""
    return _CLOCK()


def set_clock(fn=None) -> None:
    """Install ``fn`` as the process-wide monotonic clock (``None`` restores
    the real one)."""
    global _CLOCK
    _CLOCK = time.perf_counter if fn is None else fn


@contextlib.contextmanager
def override_clock(fn):
    """Temporarily replace the process clock."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = fn
    try:
        yield fn
    finally:
        _CLOCK = prev


class FakeClock:
    """A manually-advanced clock for tests: ``clock()`` returns ``now``;
    ``advance(dt)`` moves time forward; ``tick`` > 0 advances on every read."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt: float) -> None:
        self.now += float(dt)


def block_until_ready(out):
    """Wait for the device work behind ``out`` (a tensor or nested
    list/tuple/dict of them) to finish."""
    stack = [out]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                torch.cuda.synchronize(node.device)
                return out
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return out


def time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall time per call in microseconds (device work finished)."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = clock()
        block_until_ready(fn(*args))
        times.append((clock() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def timed(fn, *args, **kwargs):
    """One monotonic-clock timing of ``fn(*args, **kwargs)``: returns
    ``(result, seconds)`` with device work finished."""
    t0 = clock()
    out = fn(*args, **kwargs)
    block_until_ready(out)
    return out, clock() - t0
