"""Deterministic synthetic LM data pipeline (port of ``repro.data.pipeline``).

A seeded, restartable token stream: batch ``i`` is a pure function of
``(seed, i, host_id)`` through numpy's counter-based seeding, so a run
resumed at step N after a restart replays batch N, and every batch is
bit-equal to the reference's.  :class:`PatternLM` is a learnable stream with
the same interface (each row counts up from a seeded start), so a short run
shows its loss falling.  :class:`Prefetcher` moves batches to the
device on a side thread, from pinned host memory on a side stream, so host
generation and the copy overlap the device's compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import devices


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefix_seq: int = 0          # stub-frontend embeddings per sample
    prefix_dim: int = 0


class SyntheticLM:
    """Counter-based synthetic batches: batch(i) is a pure function of (seed, i)."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> dict:
        """``{"tokens": int32 [B, seq_len + 1]}`` (and ``"prefix_embeds"``: f32
        ``[B, prefix_seq, prefix_dim]`` with a frontend), as numpy arrays."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id])
        )
        out = {
            "tokens": rng.integers(
                0, cfg.vocab_size, (self.host_batch, cfg.seq_len + 1), dtype=np.int32
            )
        }
        if cfg.prefix_seq:
            out["prefix_embeds"] = rng.standard_normal(
                (self.host_batch, cfg.prefix_seq, cfg.prefix_dim), dtype=np.float32
            )
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PatternLM(SyntheticLM):
    """Counter-based *learnable* batches: row ``r`` of batch ``i`` is
    ``(start_r + t) % vocab_size`` for ``t`` in ``[0, seq_len]``, with the
    starts (and any frontend embeddings) drawn as :class:`SyntheticLM` draws
    its tokens.  The next token is a function of the current one, the
    pattern the repo's training tests learn; uniform tokens leave nothing to
    learn beyond the unigram, so a short run's loss only drifts there."""

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id])
        )
        start = rng.integers(0, cfg.vocab_size, (self.host_batch, 1))
        out = {"tokens": ((start + np.arange(cfg.seq_len + 1)[None]) % cfg.vocab_size)
               .astype(np.int32)}
        if cfg.prefix_seq:
            out["prefix_embeds"] = rng.standard_normal(
                (self.host_batch, cfg.prefix_seq, cfg.prefix_dim), dtype=np.float32
            )
        return out


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (through pinned memory, without
    a host wait, on the card: :func:`repro_torch.devices.upload`)."""
    dev = devices.resolve(device)
    return {k: devices.upload(np.ascontiguousarray(v), dev) for k, v in batch.items()}


class Prefetcher:
    """Background thread pushing ready batches ahead, ``depth`` at most.

    With ``device=None`` the batches come as the iterator gives them (numpy).
    With a device each batch is moved there on the thread: on the card from
    pinned host memory with ``non_blocking=True`` on a side stream, whose
    event :meth:`__next__` makes the consumer's current stream wait for, so
    the copy overlaps the device's compute and never blocks the host."""

    def __init__(self, it: Iterator[dict], depth: int = 2, device=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device = None if device is None else devices.resolve(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None and self.device.type == "cuda" else None)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self.thread.start()

    def _run(self, it):
        for batch in it:
            if self._stop.is_set():
                return
            event = None
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                             .to(self.device, non_blocking=True) for k, v in batch.items()}
                    event = torch.cuda.Event()
                    event.record(self._stream)
            elif self.device is not None:
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                         for k, v in batch.items()}
            self.q.put((batch, event))

    def __iter__(self):
        return self

    def __next__(self):
        batch, event = self.q.get()
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)   # the side stream's memory is in use here
        return batch

    def stop(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
