"""Serving: pad-masked prefill + continuous in-flight batching driver (port of
``repro.serve.serving``).

Three schedulers share the prefill/decode functions:

* ``decode="scan"`` (default) — **continuous in-flight batching**: a
  slot-based scheduler admits queued requests into KV-cache slots the moment
  earlier requests finish.  Each slot carries its own write position, pad
  length and token budget; a wave decodes ``min(remaining budgets)`` steps
  in a Python loop whose every operation stays on the device (no
  ``.item()``, no boolean-mask indexing, argmax on the device), then moves
  its token matrix to the host **once**.  Freshly prefilled slots are merged
  into the serving state with ``torch.where`` on a broadcast slot mask.
* ``decode="chunked"`` — the fixed-chunk driver: requests are cut into
  ``batch``-sized chunks; each chunk prefills together and decodes on the
  device to the chunk's worst-case budget, then moves its token matrix to
  the host **once** (the continuous scheduler's throughput baseline).
* ``decode="loop"`` — the per-token loop (one host sync per decoded token):
  the equivalence oracle.

``ServeEngine(plan=)`` serves through a :class:`repro_torch.tune.ModelPlan`:
the raw quantized tree is prepared leaf by leaf at the plan's configs
(``Model.prepare(plan=)``, fingerprint-checked).  With ``ctx=`` too,
``params`` is this rank's raw shard (``shard_tree(param_specs(...))`` of
the global raw tree) and ``plan`` the global plan, made on the global raw
tree: the fingerprint is checked against the global leaves' identities,
rebuilt from the shard and its spec over the mesh
(:func:`repro_torch.dist.sharding.global_codes_shapes`), and every rank
refuses a plan that does not match on any rank (their verdicts are
all-reduced first, so no rank is left waiting in a collective).  Each
``LayerPlan`` applies to the local leaf at its path unchanged (mode, p,
tile, prepared, ``wcanon`` with the global leaf's cap); ``n_hint`` is the
plan's, or ``batch``.  A prepared leaf's products are row-local, so each
rank's prepared bytes are the plan's per-leaf bytes times the share of each
leaf's codes it holds (checked, ``verify_capacity(shapes=)``:
``plan_bytes``); a tp group's shards sum to the plan's per-leaf bytes, a
replicated leaf counted on every rank.  A hot-swap while a sharded engine
serves flips at each rank's own next wave (no cross-rank agreement).

**Live operations** (:mod:`repro_torch.serve.ops` drives these hooks):

* *Hot-swap*: :meth:`ServeEngine.request_swap` stages a replacement tree;
  :meth:`ServeEngine._poll_swap`, the only place ``self.params`` changes
  while serving, installs it at the next admission-wave boundary of the
  continuous driver, at the next chunk boundary of the other two, at the end
  of ``generate``, or at once when idle.  In-flight slots keep decoding
  across the flip: zero requests dropped.  A tree whose quantized leaves
  drift (shape, bitwidth, numerics family, frozen calibration) or whose
  dense remainder differs is refused with a per-layer diagnostic and the
  active tree untouched.  A tree staged on another CUDA stream comes with
  the event its stage recorded; the serving stream waits on that event at
  the flip (no host sync on the serving thread).
* *Wave records*: ``on_wave`` fires once per admission wave, after the
  wave's single host sync and before the engine's own bookkeeping, with a
  :class:`WaveRecord` — the durable request log's write point
  (:mod:`repro_torch.serve.request_log`) and where failure injection lands.
  The positional signature ``on_wave(wave, admitted, emitted)`` still works
  through a deprecation shim (:meth:`ServeEngine._dispatch_wave`).
* *Structured observability*: ``ServeEngine(obs=...)`` threads a
  :class:`repro_torch.obs.Observer` through every driver.  It records only
  at the existing host syncs, from values already on the host (no
  ``.item()``, ``.cpu()`` or ``torch.cuda.synchronize()`` of its own), so
  tokens, ``host_syncs`` and ``admissions`` are those of an untraced run.
  The continuous driver records each wave; the chunked and loop drivers one
  coarse record per chunk at its last sync.

**Prefill pad mask.**  Prompt lengths are bucketed to powers of two and
left-padded into the bucket; the per-row pad length reaches the attention
mask, so left-padding is output-invariant and ``decode="scan"`` is
token-for-token identical to the loop oracle.

**Scheduler contract** (as in the reference): FIFO admission into free
slots, a wave admits as many queued requests as fit
``bucket(max prompt) + max budget <= max_seq``; ``admissions`` logs
``(request_idx, slot)``; each request gets exactly ``max_new_tokens``;
``host_syncs`` counts the device->host crossings — one per wave in the
continuous driver, one per token in the loop.

KV caches are preallocated once per call and updated **in place** (the
reference donates its buffers); the admission merge builds new tensors.

**Sharded serving** (``ServeEngine(ctx=)``, a :class:`repro_torch.dist.ShardCtx`
with a mesh; ``params`` this rank's local shards, prepared on the rank):
every rank runs the same scheduler on the same requests, and holds the
caches, tokens, write positions and pad lengths of its dp rows of the slots
(``batch`` must divide over dp).  Its caches are cut by ``cache_specs``: the
dp rows, and under ``seq_shard`` the rank's slice of the sequence on the TP
axis (each rank allocates only its shard).  The model runs the sharded
forward on them (:mod:`repro_torch.dist.runtime`), and the token matrix a
wave (chunk, loop step) returns is all-gathered over dp before its one host
sync, so every rank's scheduler sees every slot's tokens.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch import devices, timing, tree
from repro_torch.dist import runtime
from repro_torch.models.model import Model


def bucket_to(n: int, floor: int) -> int:
    """Smallest ``floor * 2^i`` that is >= ``n``; ``floor <= 1`` returns ``n``."""
    if floor <= 1:
        return n
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class WaveRecord:
    """What one admission wave did — the ``on_wave`` payload.  Every field is
    host-resident when the record is built (after the wave's single sync).
    Timestamps are :func:`repro_torch.timing.clock` seconds."""

    wave: int
    admitted: list                      # [(request_idx, slot)], this wave
    emitted: list                       # [(request_idx, slot, tokens)]
    finished: frozenset = frozenset()   # request idxs that completed
    steps: int = 0                      # decode steps run this wave
    t_start: float = 0.0
    t_decode: float = 0.0
    t_fetch: float = 0.0
    t_sync: float = 0.0
    prefill_bucket: Optional[int] = None
    queue_depth: int = 0
    active_slots: int = 0

    @property
    def sync_s(self) -> float:
        return self.t_sync - self.t_fetch


def _wave_cb_is_legacy(cb) -> bool:
    """True when ``cb`` expects the older positional signature ``(wave,
    admitted, emitted)`` rather than one :class:`WaveRecord`.  Detection is
    by required-positional-parameter count; undecidable callables (builtins)
    are treated as record-style, ``*args`` as legacy."""
    try:
        sig = inspect.signature(cb)
    except (TypeError, ValueError):
        return False
    required = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.default is p.empty:
            required += 1
    return required >= 2


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    # Live-ops annotations (consumed by repro_torch.serve.ops.LiveServer;
    # the bare engine ignores them):
    deadline_s: Optional[float] = None  # shed if still unfinished this many
                                        # seconds after serve() starts
    max_retries: Optional[int] = None   # per-request crash budget override
                                        # (None -> server default)


def admit_merge(caches, new_caches, vecs, new_vecs, mask: torch.Tensor):
    """Splice freshly prefilled slots into the serving state behind a boolean
    slot mask ``[B]``: cache leaves carry batch on axis 1 (``[n_units, B,
    ...]``), per-slot vectors on axis 0.  ``torch.where`` on a broadcast mask
    — no boolean indexing, so no host sync."""
    cm = lambda old, new: torch.where(mask.reshape((1, -1) + (1,) * (old.ndim - 2)), new, old)
    vm = lambda old, new: torch.where(mask.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)
    return tree.tree_map(cm, caches, new_caches), tuple(
        vm(o, n) for o, n in zip(vecs, new_vecs)
    )


class ServeEngine:
    """Continuous-batching serving driver (static batch slots, greedy).

    With ``plan=`` and ``ctx=`` (module docstring) ``params`` is this rank's
    raw shard: it is prepared under the global plan, whose fingerprint is
    checked against the global leaves' identities rebuilt from the shard and
    its spec over the mesh (``dist.sharding.global_codes_shapes``), each
    ``LayerPlan`` applied to the local leaf at its path; ``plan_bytes`` is
    the rank's prepared bytes, the plan's per-leaf bytes times the share of
    each leaf's codes the rank holds."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        batch: int,
        max_seq: int,
        decode: str = "scan",
        prompt_bucket: int = 8,
        plan=None,
        obs=None,
        ctx=None,
        device="cuda",
    ):
        if decode not in ("scan", "chunked", "loop"):
            raise ValueError(
                f"decode must be 'scan', 'chunked' or 'loop', got {decode!r}"
            )
        self.device = devices.resolve(device)
        if devices.tree_device(params).type != self.device.type:
            raise ValueError(
                f"params live on {devices.tree_device(params)}, engine on {self.device}"
            )
        self.model = model
        self.ctx = ctx
        self._sharded = runtime.active(ctx)
        self._rows = runtime.rows_of(batch, ctx)     # this rank's dp rows of the slots
        self._local = self._rows.stop - self._rows.start
        self._dp_group = ctx.dp_group() if self._sharded else None
        self.plan_bytes = None          # this rank's prepared bytes under a plan
        if plan is not None:
            # Autotuned serving: ``params`` is the raw quantized tree (a
            # prepared tree is frozen to one config and apply_plan refuses it);
            # under a ctx, this rank's raw shard of it.
            shapes = self._global_shapes(params, plan) if self._sharded else None
            params = model.prepare(params, plan=plan, n_hint=batch, shapes=shapes)
            if shapes is not None:
                from repro_torch.tune.planner import verify_capacity

                self.plan_bytes = sum(verify_capacity(params, plan, shapes=shapes).values())
        self.plan = plan
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.decode = decode
        self.prompt_bucket = prompt_bucket
        self.host_syncs = 0             # device->host transfers, cumulative
        self.admissions: list[tuple[int, int]] = []   # (request_idx, slot), per call
        self.bucket_counts: dict[int, int] = {}       # prefill bucket -> uses
        self.obs = obs                  # repro_torch.obs.Observer or None
        self._obs_gen = 0               # the Observer's generation of this call
        self.on_wave = None             # callback(WaveRecord)
        self.swaps = 0                  # completed hot-swaps, cumulative
        self.last_swap_wave: Optional[int] = None
        self._swap_pending = None       # (params, on_applied, ready) under _swap_lock
        self._swap_lock = threading.Lock()
        self._serving = False

    def _global_shapes(self, params, plan) -> dict:
        """The global codes shape of every leaf of this rank's raw shard, once
        every rank of the mesh has found ``plan``'s fingerprint to be its
        global tree's.  The verdicts are all-reduced over the TP and dp
        groups, a rank whose own check raised counting as a refusal, so
        either every rank raises or none does, and none is left waiting in
        the collective."""
        import torch.distributed as dist

        from repro_torch.dist.sharding import global_codes_shapes
        from repro_torch.tune.plan import param_fingerprint
        from repro_torch.tune.planner import fingerprint_mismatch

        error, fp = None, None
        try:
            shapes = global_codes_shapes(self.model.cfg, params, self.ctx)
            fp = param_fingerprint(params, shapes)
        except Exception as e:  # re-raised below, after the other ranks have heard of it
            error = e
        agree = torch.tensor([int(error is None and fp == plan.fingerprint)], dtype=torch.int32,
                             device=self.device)
        for group in (self.ctx.tp_group(), self.ctx.dp_group()):
            if group is not None:
                dist.all_reduce(agree, op=dist.ReduceOp.MIN, group=group)
        if error is not None:
            raise error
        if fp != plan.fingerprint:
            raise ValueError(fingerprint_mismatch(plan, fp))
        if not int(agree.item()):
            raise ValueError(fingerprint_mismatch(plan, fp) + " (on another rank of the mesh)")
        return shapes

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """The ONLY device->host crossing point — counted so the O(1)-syncs
        property of the continuous driver is assertable from outside."""
        self.host_syncs += 1
        return x.cpu().numpy()

    def _upload_rows(self, a: np.ndarray) -> torch.Tensor:
        """This rank's dp rows of a per-slot host array, on the device."""
        return devices.upload(np.ascontiguousarray(a[self._rows]), self.device)

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a per-slot device tensor: this rank's rows
        all-gathered over dp in a sharded engine (no host sync)."""
        if self._dp_group is None:
            return x
        return runtime.gather(x, 0, self._dp_group)

    def _new_cache(self):
        if self._sharded:
            return runtime.local_cache(self.model.cfg, self.batch, self.max_seq, torch.float32,
                                       self.ctx, self.device)
        return self.model.init_cache(self._local, self.max_seq, dtype=torch.float32,
                                     device=self.device)

    def _check_fits(self, plen: int, max_new: int) -> None:
        if plen + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new ({max_new}) exceeds max_seq {self.max_seq}"
            )

    def _validate(self, requests: list[Request]) -> None:
        for r in requests:
            if len(r.prompt) == 0:
                raise ValueError(
                    "empty prompt: with pad-masked prefill a zero-length "
                    "prompt has no valid key position to attend"
                )
            self._check_fits(len(r.prompt), r.max_new_tokens)

    def generate(self, requests: list[Request]) -> list[list[int]]:
        """Serve a list of equal-or-ragged prompts; returns per-request
        greedy tokens in request order."""
        self._validate(requests)
        self._serving = True
        if self.obs is not None:
            self._obs_gen = self.obs.serve_begin(len(requests), decode=self.decode,
                                                 batch=self.batch)
        try:
            if self.decode == "scan":
                return self._generate_continuous(requests)
            run = self._generate_batch_chunked if self.decode == "chunked" else \
                self._generate_batch_loop
            out: list[list[int]] = []
            for start in range(0, len(requests), self.batch):
                # Chunk boundary: no decode in flight, a staged swap lands here.
                self._poll_swap(start // self.batch)
                out.extend(run(requests[start : start + self.batch], start))
            return out
        finally:
            self._serving = False
            # Batch drained: the boundary a swap requested during the final
            # wave or chunk lands on.
            self._poll_swap()
            if self.obs is not None:
                self.obs.serve_end(self._obs_gen, engine=self)

    def _dispatch_wave(self, rec: WaveRecord) -> None:
        """Deliver one wave's record to ``obs`` and ``on_wave``, after the
        wave's host sync and before the engine's own output bookkeeping (the
        durable log's crash window).  ``obs`` records first, so a crash
        injected through ``on_wave`` still leaves the wave traced.  An
        ``on_wave`` written against the positional signature ``(wave,
        admitted, emitted)`` is called that way, with a
        ``DeprecationWarning``."""
        if self.obs is not None:
            self.obs.wave(rec, gen=self._obs_gen, engine=self)
        cb = self.on_wave
        if cb is None:
            return
        if _wave_cb_is_legacy(cb):
            warnings.warn(
                "ServeEngine.on_wave(wave, admitted, emitted) is deprecated; "
                "accept a single serving.WaveRecord instead (its .wave, "
                ".admitted, .emitted fields carry the old arguments). The "
                "positional shim will be removed in the next release.",
                DeprecationWarning, stacklevel=3,
            )
            cb(rec.wave, rec.admitted, rec.emitted)
        else:
            cb(rec)

    # --- live operations: double-buffered parameter hot-swap --------------

    def request_swap(self, new_params, *, check: bool = True, on_applied=None,
                     ready=None) -> None:
        """Stage ``new_params`` as the serving tree; :meth:`_poll_swap`
        installs it at the next wave or chunk boundary (at once when idle).
        In-flight slots are never dropped: they continue decoding across the
        flip.

        ``check`` (default) refuses incompatible trees — quantized-leaf
        drift (shape / bitwidth / numerics family / frozen calibration,
        diagnosed per layer) or a different dense remainder — leaving the
        active tree untouched.  ``on_applied()`` fires on the serving thread
        the moment the flip lands.  ``ready`` is a ``torch.cuda.Event``
        recorded where ``new_params`` was built on another stream: the check
        here and the serving stream at the flip wait on it."""
        if check:
            if ready is not None:
                torch.cuda.current_stream(ready.device).wait_event(ready)
            errs = self._swap_drift(self.params, new_params)
            if errs:
                shown = "; ".join(errs[:6]) + ("; ..." if len(errs) > 6 else "")
                raise ValueError(
                    f"incompatible hot-swap refused (active tree untouched): {shown}"
                )
        with self._swap_lock:
            self._swap_pending = (new_params, on_applied, ready)
        if not self._serving:
            self._poll_swap()

    @staticmethod
    def _swap_drift(old_params, new_params) -> list[str]:
        """Why two trees cannot be hot-swapped (empty list == compatible):
        the quantized leaves must share their plan-invariant identities and
        frozen calibrations (``repro_torch.tune.plan.describe_drift``), and
        the *dense* remainder — embeddings, norms, anything un-quantized —
        must match leaf for leaf in structure, shape and dtype.  The prepared
        products (``p`` / ``wpk`` / ``wcanon``, the mode within a family) may
        differ freely: those are what a plan swap replaces."""
        from repro_torch.tune.plan import describe_drift, map_quantized_leaves

        msgs = describe_drift(old_params, new_params)

        def dense_sig(params):
            # Non-tensor leaves degrade to their type name: a malformed tree
            # is refused (signature mismatch), never a crash mid-check.
            leaves: list = []

            def walk(node) -> str:
                if isinstance(node, dict):
                    return "{" + ",".join(f"{k!r}:{walk(node[k])}" for k in sorted(node)) + "}"
                if isinstance(node, (list, tuple)):
                    return "[" + ",".join(walk(v) for v in node) + "]"
                if node is None:
                    return "None"
                leaves.append((tuple(getattr(node, "shape", ())),
                               str(getattr(node, "dtype", type(node).__name__))))
                return "*"

            return walk(map_quantized_leaves(params, lambda _p, _q: None)), leaves

        if dense_sig(old_params) != dense_sig(new_params):
            msgs.append(
                "dense (non-quantized) parameter structure/shapes/dtypes "
                "differ between the active and staged trees"
            )
        return msgs

    def _poll_swap(self, wave: Optional[int] = None) -> None:
        """Install a pending staged tree, if any — the single point where
        ``self.params`` changes while serving (called only between waves /
        chunks, never with a decode in flight).  A tree built on another
        stream is ordered before every later use on this thread's stream by
        waiting on its event, and its tensors are recorded as in use here,
        so the allocator never hands their memory to the stage's stream
        while this stream may still read it."""
        with self._swap_lock:
            pending, self._swap_pending = self._swap_pending, None
        if pending is None:
            return
        new_params, on_applied, ready = pending
        if ready is not None:
            stream = torch.cuda.current_stream(ready.device)
            stream.wait_event(ready)
            for t in tree.tensors(new_params):
                t.record_stream(stream)
        self.params = new_params
        self.swaps += 1
        self.last_swap_wave = wave
        if on_applied is not None:
            on_applied()

    # --- shared helpers ---------------------------------------------------

    def _prefill(self, toks: np.ndarray, npad: np.ndarray):
        """Prefill a fresh zero cache with this rank's rows of the slots'
        prompts; returns (greedy first token [rows, 1], caches).  Prefill must
        see a zero cache, not a previous occupant's."""
        lg, fresh = self.model.prefill(
            self.params, self._upload_rows(toks), self._new_cache(),
            pad_len=self._upload_rows(npad), ctx=self.ctx, max_seq=self.max_seq,
        )
        return torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32), fresh

    def _step(self, token, caches, pos, pad):
        lg, caches = self.model.decode_step(self.params, token, caches, pos, pad_len=pad,
                                            ctx=self.ctx, max_seq=self.max_seq)
        return torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32), caches

    def _wave_bucket(self, reqs: list[Request]) -> int:
        """Prefill extent for co-admitted requests: the prompt bucket, shrunk
        to the exact max length when the bucket would push the worst-case
        decode past max_seq."""
        plen = max(len(r.prompt) for r in reqs)
        worst = max(r.max_new_tokens for r in reqs)
        plen_b = bucket_to(plen, self.prompt_bucket)
        if plen_b + worst > self.max_seq:
            plen_b = max(plen, self.max_seq - worst)
        return plen_b

    def _wave_fits(self, reqs: list[Request]) -> bool:
        plen_b = self._wave_bucket(reqs)
        return plen_b >= max(len(r.prompt) for r in reqs) and all(
            plen_b + r.max_new_tokens <= self.max_seq for r in reqs
        )

    # --- continuous driver: slot scheduler + on-device decode waves -------

    def _decode_wave(self, token, caches, pos, pad, active, steps: int):
        """``steps`` decode steps for every slot; returns ``(token, caches,
        pos, out [B, max_seq])``.  ``out[:, 0]`` is the wave-start token,
        columns ``1..steps`` this wave's tokens, inactive slots -1.  Write
        positions advance only where ``active``.  Nothing here waits for the
        device.  Every tensor here holds this rank's rows."""
        b = self._local
        out = torch.full((b, self.max_seq), -1, dtype=torch.int32, device=self.device)
        out[:, 0] = torch.where(active, token[:, 0], -1)
        act = active.to(torch.int32)
        for t in range(steps):
            token, caches = self._step(token, caches, pos, pad)
            out[:, t + 1] = torch.where(active, token[:, 0], -1)
            pos = pos + act
        return token, caches, pos, out

    def _generate_continuous(self, requests: list[Request]) -> list[list[int]]:
        b = self.batch
        self.admissions = []
        outs: list[list[int]] = [[] for _ in requests]
        queue = [i for i, r in enumerate(requests) if r.max_new_tokens > 0]
        caches = self._new_cache()
        rows = self._local         # the device state holds this rank's rows of the slots
        token = torch.zeros((rows, 1), dtype=torch.int32, device=self.device)
        pos = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        pad = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        slot_req: list[int | None] = [None] * b   # request idx per slot
        slot_rem = [0] * b                        # decode steps still owed
        qi = 0
        wave = 0
        while qi < len(queue) or any(s is not None for s in slot_req):
            # Admission-wave boundary: no decode in flight, so a staged
            # hot-swap installs atomically here — new admissions prefill
            # under the new tree, carried slots continue under it.
            self._poll_swap(wave)
            t_wave = timing.clock()
            plen_b: Optional[int] = None
            admitted: list[int] = []
            wave_reqs: list[Request] = []
            for s in range(b):
                if slot_req[s] is not None or qi >= len(queue):
                    continue
                cand = requests[queue[qi]]
                if not self._wave_fits(wave_reqs + [cand]):
                    break
                wave_reqs.append(cand)
                slot_req[s] = queue[qi]
                slot_rem[s] = cand.max_new_tokens - 1
                admitted.append(s)
                qi += 1
            if admitted:
                plen_b = self._wave_bucket(wave_reqs)
                self.bucket_counts[plen_b] = self.bucket_counts.get(plen_b, 0) + 1
                toks = np.zeros((b, plen_b), np.int32)
                npad = np.zeros((b,), np.int32)
                amask = np.zeros((b,), bool)
                for s in admitted:
                    pr = requests[slot_req[s]].prompt
                    toks[s, plen_b - len(pr) :] = pr
                    npad[s] = plen_b - len(pr)
                    amask[s] = True
                tok0, fresh = self._prefill(toks, npad)
                caches, (token, pos, pad) = admit_merge(
                    caches, fresh, (token, pos, pad),
                    (tok0, torch.full((rows,), plen_b, dtype=torch.int32, device=self.device),
                     self._upload_rows(npad)),
                    self._upload_rows(amask),
                )
                del fresh
                self.admissions.extend((slot_req[s], s) for s in admitted)
            active = np.array([s is not None for s in slot_req])
            steps = min(
                (slot_rem[s] for s in range(b) if slot_req[s] is not None), default=0
            )
            t_decode = timing.clock()
            token, caches, pos, out_dev = self._decode_wave(
                token, caches, pos, pad, self._upload_rows(active), steps
            )
            t_fetch = timing.clock()
            mat = self._fetch(self._all_rows(out_dev[:, : 1 + steps]))   # the wave's one sync
            t_sync = timing.clock()
            emitted: list[tuple[int, int, list[int]]] = []
            for s in range(b):
                i = slot_req[s]
                if i is None:
                    continue
                lo = 0 if s in admitted else 1   # col 0 = wave-start token
                emitted.append((i, s, [int(t) for t in mat[s, lo : 1 + steps]]))
            # After the sync, before the output bookkeeping: the request log's
            # write point.  Every field is already on the host.
            self._dispatch_wave(WaveRecord(
                wave=wave,
                admitted=[(slot_req[s], s) for s in admitted],
                emitted=emitted,
                finished=frozenset(i for i, s, _t in emitted if slot_rem[s] == steps),
                steps=steps,
                t_start=t_wave, t_decode=t_decode, t_fetch=t_fetch, t_sync=t_sync,
                prefill_bucket=plen_b,
                queue_depth=len(queue) - qi,
                active_slots=int(active.sum()),
            ))
            for i, s, toks_w in emitted:
                outs[i].extend(toks_w)
                slot_rem[s] -= steps
                if slot_rem[s] == 0:
                    slot_req[s] = None           # freed: next wave re-admits
            wave += 1
        return outs

    # --- chunked driver: bucketed prefill + one on-device decode per chunk -

    def _pad_prompts(self, chunk: list[Request], plen: int):
        """Left-pad ragged prompts into a [batch, plen] matrix; returns the
        tokens and the per-row pad lengths (the prefill pad mask)."""
        toks = np.zeros((self.batch, plen), np.int32)
        pad = np.zeros((self.batch,), np.int32)
        for i, r in enumerate(chunk):
            toks[i, plen - len(r.prompt) :] = r.prompt          # left-pad
            pad[i] = plen - len(r.prompt)
        return toks, pad

    def _generate_batch_chunked(self, chunk: list[Request], start: int = 0) -> list[list[int]]:
        """Prefill the chunk at its prompt bucket, decode every row to the
        chunk's worst-case budget on the device, fetch the token matrix
        once.  Rows past their own budget keep stepping; the host keeps each
        row's first ``max_new_tokens``.  ``start`` is the chunk's first
        request index (the ``obs`` record's request ids)."""
        t_wave = timing.clock()
        plen = max(len(r.prompt) for r in chunk)
        max_new = max(r.max_new_tokens for r in chunk)
        # The whole chunk decodes to the worst-case budget, so the chunk's
        # (max plen, max budget) pair must fit, not just each request.
        self._check_fits(plen, max_new)
        if max_new == 0:
            return [[] for _ in chunk]
        # Decode length bucketed to a power of two, as the reference buckets
        # its traces; the exact budget where the bucket would overflow.
        length = bucket_to(max_new, 2)
        if plen + length > self.max_seq:
            length = max_new
        plen_b = min(bucket_to(plen, self.prompt_bucket), self.max_seq - length)
        self.bucket_counts[plen_b] = self.bucket_counts.get(plen_b, 0) + 1
        toks, pad = self._pad_prompts(chunk, plen_b)
        token, caches = self._prefill(toks, pad)
        pad_dev = self._upload_rows(pad)
        t_decode = timing.clock()
        ys = torch.empty((self._local, length), dtype=torch.int32, device=self.device)
        ys[:, 0] = token[:, 0]
        for t in range(length - 1):
            token, caches = self._step(token, caches, plen_b + t, pad_dev)
            ys[:, t + 1] = token[:, 0]
        t_fetch = timing.clock()
        mat = self._fetch(self._all_rows(ys))   # the chunk's single device->host sync
        t_sync = timing.clock()
        outs = [[int(t) for t in mat[i, : chunk[i].max_new_tokens]]
                for i in range(len(chunk))]
        if self.obs is not None:
            # One coarse record a chunk (a chunk is one "wave"), at its sync.
            self.obs.wave(self._chunk_record(chunk, start, outs, steps=length, t_start=t_wave,
                                             t_decode=t_decode, t_fetch=t_fetch, t_sync=t_sync,
                                             bucket=plen_b),
                          gen=self._obs_gen, engine=self)
        return outs

    def _chunk_record(self, chunk, start, outs, *, steps, t_start, t_decode, t_fetch, t_sync,
                      bucket) -> WaveRecord:
        """The chunked and loop drivers' coarse per-chunk record: every row
        admitted into slot ``i``, and finished, within the chunk."""
        return WaveRecord(
            wave=start // self.batch,
            admitted=[(start + i, i) for i in range(len(chunk))],
            emitted=[(start + i, i, outs[i]) for i in range(len(chunk))],
            finished=frozenset(start + i for i in range(len(chunk))),
            steps=steps, t_start=t_start, t_decode=t_decode, t_fetch=t_fetch, t_sync=t_sync,
            prefill_bucket=bucket, queue_depth=0, active_slots=len(chunk),
        )

    # --- oracle: per-token loop ---------------------------------------------

    def _generate_batch_loop(self, chunk: list[Request], start: int = 0) -> list[list[int]]:
        """Prefill the chunk at its exact max prompt length, then one decode
        step and one host sync per token.  ``start`` is the chunk's first
        request index (the ``obs`` record's request ids)."""
        t_wave = timing.clock()
        plen = max(len(r.prompt) for r in chunk)
        self._check_fits(plen, max(r.max_new_tokens for r in chunk))
        self.bucket_counts[plen] = self.bucket_counts.get(plen, 0) + 1
        toks, pad = self._pad_prompts(chunk, plen)
        token, caches = self._prefill(toks, pad)
        pad_dev = self._upload_rows(pad)
        max_new = max(r.max_new_tokens for r in chunk)
        outs: list[list[int]] = [[] for _ in chunk]
        if max_new == 0:
            return outs
        tok_h = self._fetch(self._all_rows(token))  # one sync per decoded step
        for i, r in enumerate(chunk):
            if r.max_new_tokens > 0:
                outs[i].append(int(tok_h[i, 0]))
        for t in range(max_new - 1):
            token, caches = self._step(token, caches, plen + t, pad_dev)
            tok_h = self._fetch(self._all_rows(token))
            for i, r in enumerate(chunk):
                if len(outs[i]) < r.max_new_tokens:
                    outs[i].append(int(tok_h[i, 0]))
        if self.obs is not None:
            # The loop syncs every step; one coarse record a chunk, ending at
            # its last sync, keeps the SLO stats comparable across drivers.
            t_sync = timing.clock()
            self.obs.wave(self._chunk_record(chunk, start, outs, steps=max_new, t_start=t_wave,
                                             t_decode=t_wave, t_fetch=t_wave, t_sync=t_sync,
                                             bucket=plen),
                          gen=self._obs_gen, engine=self)
        return outs
