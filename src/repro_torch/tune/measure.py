"""Measurement harness: correct the analytic estimates with measured time
(port of ``repro.tune.measure``).

The analytic candidate estimates (:mod:`repro_torch.tune.space`) price
candidates with the paper's UPMEM cycle model, the right currency for the
PIM device but not for the card this port runs on.  The planner therefore
corrects them by timing each candidate's ``apply_linear`` directly: warmup
calls first (the kernels' first build lands there), then the median of
``iters`` timed calls.

Measurements are cached process-wide by the candidate's full identity
``(f, k, n, bw, ba, p, mode, tile_n, buffer_bytes, wcanon, prepared,
kinds)``, so a sweep over many budgets measures each distinct config once.
``Measurer(obs=)`` counts the cache's hits and misses and records one
``tune`` span per miss (:meth:`repro_torch.obs.Observer.measurement`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import devices, timing
from repro_torch.core import api
from repro_torch.core.prepared import WCANON_MAX_ENTRIES, prepare_linear
from repro_torch.tune.space import Candidate


def measure_key(f: int, k: int, n: int, spec: api.LutLinearSpec, cand: Candidate):
    return (
        f, k, n, spec.bw, spec.ba, cand.p, cand.mode, cand.tile_n,
        cand.buffer_bytes, cand.wcanon, cand.prepared, spec.w_kind, spec.a_kind,
    )


def _cuda_us(fn, x: torch.Tensor, *, iters: int, warmup: int) -> float:
    """Median over ``iters`` calls of the time between two CUDA events
    recorded on the current stream around one call, microseconds.  The card
    is idle when each start event is recorded, so the number covers the
    call's device work and, where the host enqueues its launches more slowly
    than the card runs them, the host's launch time as well."""
    for _ in range(warmup):
        fn(x)
    torch.cuda.synchronize(x.device)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    times.sort()
    return times[len(times) // 2]


class Measurer:
    """Timed ``apply_linear`` per candidate, cached by candidate identity."""

    def __init__(self, *, iters: int = 3, warmup: int = 1, cache: Optional[dict] = None,
                 obs=None):
        self.iters = iters
        self.warmup = warmup
        self.cache = _GLOBAL_CACHE if cache is None else cache
        self.obs = obs                  # repro_torch.obs.Observer or None
        self.hits = 0
        self.misses = 0

    def measure(self, q, x: torch.Tensor, cand: Candidate) -> float:
        """Median microseconds of one eager ``apply_linear`` call through the
        candidate's config, on the concrete raw layer ``q`` and activation
        sample ``x`` (``[n, K]``).

        On a CUDA tensor the time is taken with CUDA events
        (:func:`_cuda_us`).  The reference times one jitted call, a single
        dispatch; here the call is eager, about two dozen launches a
        projection on the lut path, so the host's launch time is part of
        what is measured.  On the CPU: the host clock
        (:func:`repro_torch.timing.time_fn`).

        With ``obs``, a miss's ``tune`` span ends at the host clock read
        after the last timed call finished (on a card, after its end event's
        ``synchronize``) and starts ``us`` earlier, as in the reference."""
        key = measure_key(q.f, q.k, x.shape[0], q.spec, cand)
        if key in self.cache:
            self.hits += 1
            if self.obs is not None:
                self.obs.measurement(key, self.cache[key], cached=True)
            return self.cache[key]
        self.misses += 1
        qq = dataclasses.replace(q, spec=cand.spec_for(q.spec))
        layer = qq
        if cand.prepared:
            layer = prepare_linear(
                qq, n_hint=x.shape[0],
                wcanon_max_entries=WCANON_MAX_ENTRIES if cand.wcanon else 0,
            )
        fn = lambda xx: api.apply_linear(layer, xx)
        if x.is_cuda:
            us = _cuda_us(fn, x, iters=self.iters, warmup=self.warmup)
        else:
            us = timing.time_fn(fn, x, iters=self.iters, warmup=self.warmup)
        self.cache[key] = us
        if self.obs is not None:
            self.obs.measurement(key, us, cached=False)
        return us


_GLOBAL_CACHE: dict = {}


def clear_cache() -> None:
    _GLOBAL_CACHE.clear()


def sample_activations(k: int, n: int, seed: int = 0, *, device="cuda") -> torch.Tensor:
    """Deterministic activation sample ``[n, k]`` f32 for measurement and
    planning: the reference's ``default_rng(seed).normal`` values, on
    ``device``."""
    rng = np.random.default_rng(seed)
    return devices.upload(rng.normal(size=(n, k)).astype(np.float32), devices.resolve(device))
