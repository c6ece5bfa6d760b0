"""Continuous-batching serving engine: PWS-disciplined slot scheduling over
per-row KV decode.  The port of ``repro/launch/engine.py``.

The lockstep :class:`~repro_torch.launch.serve.Server` decodes a fixed wave
of requests at one shared position: rows that finish early burn decode
steps until the slowest request ends, and a new wave cannot start until the
old one drains.  This engine removes both stalls:

* **Per-row KV lengths.**  Every decode step runs the whole ``max_batch``
  at once, but each slot carries its own position: the attention kernel's
  per-row ``q_offset``/``kv_len`` lanes (device tensors) mask each row's
  cache prefix, so rows at different depths share one launch.
* **Slot reuse.**  A request that hits EOS / ``max_new`` / the cache
  capacity releases its slot at once (an *eviction*); the next queued
  request is admitted into it without waiting for the rest of the batch.
* **Batched chunked prefill.**  Prompts stream into the cache in
  fixed-size chunks (``Model.prefill_chunk``), and every prefilling slot
  advances each iteration through at most TWO padded full-batch launches —
  one for first chunks (int8 scale calibration runs there), one for
  continuations — with per-row ``(b,)`` offsets and valid-token ``lens``
  (0 parks a row).
* **PWS slot scheduling.**  Admission is the paper's §4.7 priority-matching
  discipline through ``core.pws.match_round``: queued requests are
  stealable tasks, idle slots are thieves, priority = work remaining.
  Rounds match at most ``p - 1`` requests (Obs. 4.3, asserted) and round
  priorities never increase within a drain (asserted).
* **Eviction under memory pressure.**  An optional ``cache_budget`` (total
  live context tokens across slots) evicts the ``largest`` or ``coldest``
  slot while over budget; its request re-queues with its generated tokens
  folded into the prompt (greedy replay is token-identical).

**Failure model** (``runtime.fault_tolerance``'s taxonomy on launches):

(a) *Hard launch failure.*  A launch that exhausts its ``FaultPolicy``
    retries raises ``LaunchFailedError`` out of :meth:`Engine.run`.  A CUDA
    error (a kernel that does not build, a sticky fault) fails every retry
    and surfaces this way; the engine never moves to the CPU on its own.
    :meth:`Engine.restart` rebuilds a replica from the latest checkpoint
    (the fleet router's respawn and join path).
(b) *Transient launch fault / poisoned row.*  Every launch runs under
    bounded retry with seeded backoff.  The port writes the cache in place
    (``models.cache``), so a retried launch writes the same positions with
    the same values again: the retry is sound because injected faults fire
    BEFORE the launch (``FaultInjector.before_launch``), and a launch that
    failed part way rewrites what it wrote identically (a first chunk's
    scales are recomputed from the same fresh k/v); recurrent state
    (``StateCarry``) comes back in new tensors, so a retry starts from the
    state the failed launch read.  A row whose logits go
    non-finite is bisected by the per-row validity vector the decode step
    returns: only that slot is evicted and its request re-queued, its token
    suppressed, so greedy replay (from its last row snapshot, else the full
    effective prompt) keeps its tokens identical to a clean run.
(c) *Stragglers + graceful degradation.*  Each launch's host wall time
    feeds a ``LaunchWatchdog``: one straggler series per kind of launch
    (decode steps, first chunks, continuation chunks), cleared per run, a
    flag needing both ``WATCHDOG_K_SIGMA`` deviations and
    ``WATCHDOG_FLOOR`` times the series' median; flagged launches and
    failed attempts count as fault events.  ``degrade_after`` events within
    ``degrade_window`` iterations shrink the active-slot limit by one;
    ``heal_after`` healthy iterations probe back up.  Scheduling only:
    tokens are unaffected.  On the card the watchdog times the launch's
    enqueue, not its kernels (the host read of the tokens comes after it);
    it adds no synchronisation to find out.  ``stats()["watchdog"]`` gives
    each series' median and the largest time over it that an unfaulted run
    reached.

Row snapshots (``models.cache.snapshot_row``/``restore_row``) are host
copies taken every ``snapshot_every`` generated tokens.

**On a mesh of more than one rank** (the dense family; ``launch/mesh.py``)
the scheduler and this host loop run identically on every rank.  Each data
rank owns its block of the slots when the slot count divides the data
axis (the cache holds its rows and its KV heads), else every data rank
computes every row; the sampled tokens and the row validity are gathered
each step, so every rank takes the same decisions.  A row operation
(reset, validity, snapshot, restore) runs on the rank that owns the row;
a snapshot is broadcast from it over the data axis, so any rank can
restore it into any slot.  Fault plans fire by launch ordinal, on every
rank together, so retries stay in lockstep; any other failure is not
retried on a sharded mesh: it raises on its rank, and the others raise
through the group's timeout (``mesh.DEFAULT_TIMEOUT_S``).

**Modality staging** (the encoder-decoder's ``audio_frames``, the VLM's
``image_embeds``; JAX ``engine.py:274-280, :504-506, :536-539``): one host
buffer per ``batch_extras_specs`` entry, ``(max_batch, ...)`` in the
spec's dtype.  Admission writes a request's ``extras`` into its slot's row
(a request without extras leaves the row as it was, as in JAX); every
first-chunk launch ships the whole buffers, and the model writes the
cross-attention cache of its live rows only.  A request evicted, poisoned
or drained and replayed from its prompt is admitted again, so its first
chunk reads its own row again; one resumed from a snapshot restores its
cross-attention cache with the row.  Extras whose key or row shape does
not match a spec raise ``ValueError`` naming the key when the request is
queued (``begin``, ``adopt``).

Numerics contract: with greedy decoding the engine's per-request tokens are
IDENTICAL to running each request alone through the lockstep path
(:func:`check_lockstep_parity`); with an int8 cache this needs ``chunk`` >=
the longest prompt, since lockstep prefill calibrates the scales over the
whole prompt and the engine over the first chunk.  An MoE config's expert
capacity is per call, so a token that the batched step drops may be kept
when its request runs alone (as in the JAX engine): the parity holds where
no expert overflows.  The recurrent families (``hybrid``, ``ssm``) are
exact because parked rows carry identity state updates; the hybrid needs
``chunk`` >= the longest prompt (the LRU's h0 fold reassociates across
chunk boundaries) and the SSM prompt and chunk lengths on ``cfg.ssm_chunk``
multiples, as in JAX.  Against the JAX engine at the same ``chunk`` the
port is exact either way.

    python -m repro_torch.launch.engine --arch qwen3-moe-30b-a3b
    python -m repro_torch.launch.engine --arch olmoe-1b-7b --reduced --device cpu
    python -m repro_torch.launch.engine --arch gemma3-1b --reduced --device cpu --chunk 5
    python -m repro_torch.launch.engine --arch recurrentgemma-2b --reduced --device cpu \
        --chunk 32 --check-lockstep
    python -m repro_torch.launch.engine --arch mamba2-370m --reduced --device cpu \
        --chunk 8 --prompt-align 8 --check-lockstep
    python -m repro_torch.launch.engine --arch seamless-m4t-large-v2 --reduced --device cpu \\
        --chunk 5 --check-lockstep
    python -m repro_torch.launch.engine --arch llama-3.2-vision-90b --reduced --device cpu \\
        --chunk 5 --check-lockstep
    python -m repro_torch.launch.engine --reduced --device cpu
    python -m repro_torch.launch.engine --reduced --device cpu \\
        --impl 'attention=pallas:kv_dtype=int8' --chunk 24 --check-lockstep
"""
from __future__ import annotations

import argparse
import functools
import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import collectives, planner, pws
from repro_torch.kernels import autotune, policy
from repro_torch.launch.serve import Request, Server, install_impl
from repro_torch.models import cache as dcache
from repro_torch.models.base import Model, RunOptions, UnsupportedFamilyError
from repro_torch.runtime.fault_tolerance import (
    FaultInjector,
    FaultPolicy,
    InjectedFault,
    LaunchFailedError,
    LaunchWatchdog,
    export_fault_counters,
)

log = logging.getLogger("repro_torch.engine")


class SlotScheduler:
    """Deterministic slot↔request matcher on the PWS §4.7 round discipline.

    One :meth:`assign` call drains as many matching rounds as the idle-slot
    supply allows.  Each round goes through :func:`pws.match_round` — idle
    slots (thieves, ranked by slot index) matched positionally to the
    queued requests holding the round's best priority (victims, by queue
    index) — then enforces and ASSERTS the paper's bounds: at most ``p - 1``
    matches per round (Obs. 4.3; ``p`` = slot count), and non-increasing
    round priorities within the drain (§4.1).  Counters double as the
    engine's telemetry.
    """

    def __init__(self, n_slots: int):
        self.p = max(int(n_slots), 1)
        self.counters = {
            "matches": 0,        # requests admitted into slots (steals)
            "rounds": 0,         # matching rounds run
            "evictions": 0,      # slot releases (stop / capacity)
            "pressure_evictions": 0,  # budget evictions (request re-queued)
            "drains": 0,         # fleet-level slot releases (migration/leave)
            "max_round_matches": 0,
            # fault-tolerance telemetry (engine-incremented)
            "retries": 0,             # launch retry attempts
            "faults_injected": 0,     # mirrored from the FaultInjector
            "slots_poisoned": 0,      # non-finite rows bisected + evicted
            "snapshots_taken": 0,     # host-staged row snapshots
            "snapshot_restores": 0,   # re-admissions resumed from a snapshot
            "stragglers": 0,          # watchdog-flagged slow launches
            "degradations": 0,        # active-slot-limit shrinks
            "degraded_iters": 0,      # iterations run below full slot count
        }

    def assign(self, idle_slots, queue, priority):
        """Match ``idle_slots`` to entries of ``queue`` (``priority(r)`` =
        work remaining).  Returns ``[(slot, queue_index), ...]`` in match
        order; the caller admits and pops.  Deterministic in its inputs."""
        bound = max(self.p - 1, 1)
        idle = [(s, s) for s in sorted(idle_slots)]
        taken: set[int] = set()
        assignments: list[tuple[int, int]] = []
        last_best: Optional[int] = None
        while idle:
            heads = [(i, priority(r)) for i, r in enumerate(queue)
                     if i not in taken]
            best, pairs = pws.match_round(idle, heads)
            if best is None:
                break
            # Obs. 4.3: at most p-1 tasks of the round's priority are stolen
            pairs = pairs[:bound]
            assert len(pairs) <= bound, \
                "PWS bounded-steals-per-round invariant violated"
            assert last_best is None or best <= last_best, \
                "PWS round priorities must be non-increasing"
            last_best = best
            self.counters["rounds"] += 1
            self.counters["max_round_matches"] = max(
                self.counters["max_round_matches"], len(pairs))
            for pair, qidx in pairs:
                idle.remove(pair)
                taken.add(qidx)
                assignments.append((pair[1], qidx))
                self.counters["matches"] += 1
        return assignments


@dataclass
class _Slot:
    """One decode lane of the fixed-size batch."""
    req: Optional[Request] = None
    state: str = "empty"      # empty | prefill | decode
    filled: int = 0           # cache positions written (prefill progress)
    pos: int = 0              # next decode position (== tokens in context)
    last_token: int = 0
    # engine iteration of the slot's last progress: the recency stamp the
    # "coldest" eviction policy keys on
    last_step: int = -1
    # the residency's effective prompt: the request's prompt plus any tokens
    # generated before a pressure eviction (replayed on re-admit)
    prompt: Optional[np.ndarray] = None

    @property
    def context(self) -> int:
        """Live cache tokens this slot holds (budget accounting)."""
        return self.pos if self.state == "decode" else self.filled


class Engine(Server):
    """Continuous-batching engine over the lockstep :class:`Server`'s model
    (adds the per-row decode step and the batched chunked-prefill step).
    ``cache_budget`` (total live context tokens) turns on eviction under
    memory pressure."""

    def __init__(self, cfg, *, mesh=None, device=None, params: Optional[dict] = None,
                 max_batch: int = 4, max_len: int = 256, chunk: int = 16,
                 eos_id: Optional[int] = None,
                 cache_budget: Optional[int] = None,
                 evict_policy: str = "largest",
                 fault_policy: Optional[FaultPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 snapshot_every: int = 16,
                 degrade_after: int = 3, degrade_window: int = 8,
                 heal_after: int = 16, opts: Optional[RunOptions] = None):
        super().__init__(cfg, mesh=mesh, device=device, params=params, max_batch=max_batch,
                         max_len=max_len, opts=opts)
        for name in ("init_cache", "prefill_chunk", "decode_step"):
            impl = getattr(type(self.model), name, None)
            if impl is None or impl is getattr(Model, name, None):
                raise UnsupportedFamilyError(cfg.family, name)
        # host staging for modality-frontend inputs: one full-batch buffer
        # per spec, rows written at admission, shipped with first chunks
        self._extras_specs = self.model.batch_extras_specs(max_batch, max_len)
        self._extras_host = {k: torch.zeros(sp.shape, dtype=sp.dtype)
                             for k, sp in self._extras_specs.items()} or None
        self.chunk = int(chunk)
        self.eos_id = eos_id
        self.cache_budget = cache_budget
        if evict_policy not in ("largest", "coldest"):
            raise ValueError(f"unknown evict_policy {evict_policy!r}: "
                             "expected 'largest' or 'coldest'")
        self.evict_policy = evict_policy
        self.fault_policy = fault_policy or FaultPolicy()
        self.injector = FaultInjector.from_env() if injector is None \
            else injector
        self.snapshot_every = int(snapshot_every)
        self.degrade_after = int(degrade_after)
        self.degrade_window = int(degrade_window)
        self.heal_after = int(heal_after)
        self.watchdog = LaunchWatchdog()
        self.scheduler = SlotScheduler(max_batch)
        self._tp = planner.axes_for(self.mesh).tp if self.sharded else None
        prov = autotune.provenance(self.device)
        log.info("engine policy %s | autotune table %s (%d tuned plan(s), %s) | "
                 "faults %s | retry max=%d snapshot_every=%d",
                 policy.current().describe(), prov["table"], prov["tuned_plans"],
                 "present" if prov["table_exists"] else "absent",
                 self.injector.describe(), self.fault_policy.max_retries,
                 self.snapshot_every)
        self._chunk_first = functools.partial(self._chunk_step, first=True)
        self._chunk_cont = functools.partial(self._chunk_step, first=False)
        self.begin([])  # stats() and adopt() are valid before the first run

    @classmethod
    def restart(cls, cfg, ckpt_dir, *, mesh=None, device=None, **kw) -> "Engine":
        """Failure model (a): rebuild a serving replica on ``mesh`` (default:
        the ``(1, 1)`` mesh of ``device``) with params from the latest
        checkpoint under ``ckpt_dir`` (the JAX package's format) via
        ``elastic.serving_restore``: the model's names, shapes and dtypes
        come from a copy built on the ``meta`` device, the leaves are read
        and placed by the plan on the mesh and loaded, so the restored
        replica's logits equal the original's.  Caches start empty;
        in-flight requests re-enter through admission and replay."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.launch.mesh import axis_sizes, mesh_for
        from repro_torch.models import build_model
        from repro_torch.runtime import elastic

        mesh = mesh_for(mesh, device, "Engine.restart")
        like = build_model(cfg, kw.get("opts"), device="meta").state_dict()
        step, params = elastic.serving_restore(CheckpointManager(ckpt_dir), like, mesh)
        eng = cls(cfg, mesh=mesh, params=params, **kw)
        log.info("engine restarted from step-%d checkpoint on mesh %s", step,
                 axis_sizes(mesh))
        return eng

    # -- the two launches ----------------------------------------------------
    def _decode_rows(self, tokens, pos, cache, poison):
        """One per-row decode step.  ``poison`` (b,) bool is the injected
        fault's mask; the per-row finiteness vector is the bisection signal
        the host uses to evict exactly the corrupt slot.  Takes and returns
        every row (this rank's block runs, the rest is gathered)."""
        lo, hi = self._lo, self._hi
        with self.bound(self.max_batch):
            logits, cache = self.model.decode_step(tokens[lo:hi], pos[lo:hi], cache)
        logits = logits.masked_fill(poison[lo:hi, None], float("nan"))
        bad = (~torch.isfinite(logits)).any(dim=-1)
        if self.sharded:  # a row is bad where any rank's vocabulary block is
            bad = collectives.all_sum(bad.float(), self.mesh, self._tp) > 0
        nxt = self.greedy(logits)
        return self.gather_rows(nxt, self._row_axes), \
            self.gather_rows(~bad, self._row_axes), cache

    def _chunk_step(self, tokens, offset, lens, cache, extras, *, first):
        lo, hi = self._lo, self._hi
        if extras is not None:
            extras = {k: v[lo:hi] for k, v in extras.items()}
        with self.bound(self.max_batch):
            logits, cache = self.model.prefill_chunk(tokens[lo:hi], offset[lo:hi], cache,
                                                     first=first, lens=lens[lo:hi],
                                                     extras=extras)
        return self.gather_rows(self.greedy(logits), self._row_axes), cache

    # -- rows of the cache on a sharded mesh ---------------------------------
    def _row(self, i: int) -> Optional[int]:
        """Slot ``i``'s row in this rank's cache, or None where another data
        rank owns it."""
        return i - self._lo if self._lo <= i < self._hi else None

    def _row_op(self, fn, i: int, *args):
        """``self.cache = fn(self.cache, row, *args)`` on the rank that owns
        slot ``i``."""
        j = self._row(i)
        if j is not None:
            self.cache = fn(self.cache, j, *args)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- modality staging ----------------------------------------------------
    def _check_extras(self, req: Request):
        """Raise ``ValueError`` naming the key when ``req.extras`` holds a
        key no spec names or a row whose shape is not the spec's row."""
        for key, val in (req.extras or {}).items():
            spec = self._extras_specs.get(key)
            if spec is None:
                raise ValueError(f"request {req.uid}: extras key {key!r} is not one of "
                                 f"the model's inputs {sorted(self._extras_specs)}")
            if tuple(np.shape(val)) != tuple(spec.shape[1:]):
                raise ValueError(f"request {req.uid}: extras[{key!r}] has shape "
                                 f"{tuple(np.shape(val))}; a row is {tuple(spec.shape[1:])}")

    def _stage_extras(self, i: int, req: Request):
        """Write ``req``'s modality inputs into slot ``i``'s staged rows."""
        for key, val in (req.extras or {}).items():
            self._extras_host[key][i].copy_(torch.as_tensor(val))

    # -- scheduling ----------------------------------------------------------
    @staticmethod
    def _effective_prompt(req: Request) -> np.ndarray:
        """The tokens a residency must prefill: the prompt, plus (after a
        pressure eviction) every token already generated."""
        prompt = np.asarray(req.prompt, np.int32)
        if req.out:
            prompt = np.concatenate([prompt, np.asarray(req.out, np.int32)])
        return prompt

    @staticmethod
    def _work_remaining(req: Request, filled: int = 0) -> int:
        """The PWS priority: context tokens still to prefill plus tokens
        still to generate — larger tasks first."""
        return ((len(req.prompt) + len(req.out) - filled)
                + (req.max_new - len(req.out)))

    def _evict(self, i: int):
        self.slots[i] = _Slot()
        self.scheduler.counters["evictions"] += 1

    # -- fault handling ------------------------------------------------------
    def _launch(self, kind: str, fn, *args, series: Optional[str] = None):
        """Run one launch under the failure model: the injector may raise or
        delay it, failures retry up to ``FaultPolicy.max_retries`` with
        seeded exponential backoff, and the watchdog z-scores its host wall
        time within its ``series`` (default ``kind``).  Retrying the same
        arguments is sound because injected faults fire before the launch
        and a partial launch rewrites identical values (see the module
        docstring).  Exhausted retries escalate as
        :class:`LaunchFailedError` (failure model (a))."""
        ordinal = self._launch_seq[kind]
        self._launch_seq[kind] = ordinal + 1
        counters = self.scheduler.counters
        last: Optional[BaseException] = None
        for attempt in range(self.fault_policy.max_retries + 1):
            if attempt:
                counters["retries"] += 1
                time.sleep(self.fault_policy.backoff(attempt - 1,
                                                     self._fault_rng))
            t0 = time.perf_counter()
            try:
                self.injector.before_launch(kind, ordinal)
                out = fn(*args)
            except Exception as e:  # noqa: BLE001 — any launch fault retries
                if self.sharded and not isinstance(e, InjectedFault):
                    raise  # the other ranks raise through the group's timeout
                last = e
                self._note_fault()
                log.warning("%s launch %d attempt %d failed: %r",
                            kind, ordinal, attempt, e)
                continue
            if self.watchdog.observe(series or kind, time.perf_counter() - t0):
                counters["stragglers"] += 1
                self._note_fault()
                log.warning("straggler %s launch %d", kind, ordinal)
            return out
        raise LaunchFailedError(kind, ordinal,
                                self.fault_policy.max_retries + 1) from last

    def _note_fault(self):
        """One fault event (failed attempt, straggler, poisoned row) lands
        in the degradation window."""
        self._recent_faults.append(self._iter)
        self._last_fault_iter = self._iter

    def _update_degradation(self):
        """Failure model (c): shrink the active-slot limit after
        ``degrade_after`` fault events inside ``degrade_window`` iterations
        (occupants above the limit drain naturally), probe back up one slot
        per ``heal_after`` healthy iterations."""
        counters = self.scheduler.counters
        cutoff = self._iter - self.degrade_window
        self._recent_faults = [t for t in self._recent_faults if t >= cutoff]
        if (len(self._recent_faults) >= self.degrade_after
                and self._active_limit > 1):
            self._active_limit -= 1
            self._recent_faults.clear()  # fresh evidence before the next cut
            counters["degradations"] += 1
            log.warning("degraded to %d/%d active slots",
                        self._active_limit, self.max_batch)
        elif (self._active_limit < self.max_batch
                and self._iter - self._last_fault_iter >= self.heal_after):
            self._active_limit += 1
            self._last_fault_iter = self._iter  # one probe per heal window
        if self._active_limit < self.max_batch:
            counters["degraded_iters"] += 1
        self._iter += 1

    def _poisoned(self, i: int):
        """Failure model (b), after bisection: slot ``i``'s row went
        non-finite.  Only this slot is evicted; its request re-queues and
        resumes from its last snapshot (or a full effective-prompt replay)."""
        req = self.slots[i].req
        self.slots[i] = _Slot()
        self.queue.append(req)
        self.scheduler.counters["slots_poisoned"] += 1
        self._note_fault()
        log.warning("poisoned slot %d: evicted uid=%d for replay", i, req.uid)

    def _take_snapshot(self, i: int):
        """Host-stage row ``i`` as its request's resume point."""
        s = self.slots[i]
        j = self._row(i)
        row = None if j is None else dcache.snapshot_row(self.cache, j)
        if self._row_axes is not None:  # from the data rank that owns it
            row = collectives.broadcast_object(row, self.mesh, self._row_axes[0],
                                               i // (self._hi - self._lo))
        self._snaps[s.req.uid] = {
            "row": row,
            "pos": s.pos, "n_out": len(s.req.out), "last": s.last_token,
        }
        self.scheduler.counters["snapshots_taken"] += 1

    def _emit(self, i: int, tok: int) -> bool:
        """Record one generated token for slot ``i``; returns True (and
        evicts) when the request stops: max_new, EOS, or a full cache."""
        slot = self.slots[i]
        r = slot.req
        r.out.append(tok)
        # slot.pos is the NEXT write position: at max_len the cache is full
        stop = (len(r.out) >= r.max_new
                or (self.eos_id is not None and tok == self.eos_id)
                or slot.pos >= self.max_len)
        if stop:
            self._completed.append(r)
            self._snaps.pop(r.uid, None)  # resume point no longer needed
            self._evict(i)
        return stop

    # -- engine loop ---------------------------------------------------------
    def _admit(self):
        # degradation shrinks the admissible slot range
        idle = [i for i, s in enumerate(self.slots[:self._active_limit])
                if s.state == "empty"]
        if not idle or not self.queue:
            return
        matched = self.scheduler.assign(idle, self.queue, self._work_remaining)
        # pop in descending queue order so earlier indices stay valid
        for slot_id, qidx in sorted(matched, key=lambda m: -m[1]):
            req = self.queue.pop(qidx)
            snap = self._snaps.get(req.uid)
            if snap is not None:
                # resume from the last row snapshot: restore the row, cut the
                # output back to the snapshot point, replay the greedy tail
                self._row_op(dcache.restore_row, slot_id, snap["row"])
                del req.out[snap["n_out"]:]
                self.slots[slot_id] = _Slot(req=req, state="decode",
                                            filled=snap["pos"], pos=snap["pos"],
                                            last_token=snap["last"],
                                            last_step=self._iter)
                self.scheduler.counters["snapshot_restores"] += 1
                continue
            self.slots[slot_id] = _Slot(req=req, state="prefill", filled=0,
                                        last_step=self._iter,
                                        prompt=self._effective_prompt(req))
            # slabs are NOT zeroed: write-before-attend makes stale tokens
            # unreachable
            self._row_op(dcache.reset_row, slot_id)
            if self._extras_host is not None:
                self._stage_extras(slot_id, req)

    def _advance_prefill(self):
        """Advance EVERY prefilling slot by one chunk, batched: one padded
        full-batch launch for first chunks and one for continuations, each
        with per-row offsets and valid-token ``lens`` (0 parks a row at its
        context depth, where its own next write lands first).  A slot whose
        chunk finishes its prompt flips to decode with its first token."""
        first = [i for i, s in enumerate(self.slots)
                 if s.state == "prefill" and s.filled == 0]
        cont = [i for i, s in enumerate(self.slots)
                if s.state == "prefill" and s.filled > 0]
        for group, fn, series in ((first, self._chunk_first, "prefill_first"),
                                  (cont, self._chunk_cont, "prefill_cont")):
            if not group:
                continue
            t0 = time.perf_counter()
            toks = np.zeros((self.max_batch, self.chunk), np.int32)
            offset = np.zeros((self.max_batch,), np.int32)
            lens = np.zeros((self.max_batch,), np.int32)
            for i, s in enumerate(self.slots):
                if i in group:
                    end = min(s.filled + self.chunk, len(s.prompt))
                    toks[i, :end - s.filled] = s.prompt[s.filled:end]
                    offset[i] = s.filled
                    lens[i] = end - s.filled
                else:  # park: overwritten before anything attends it
                    offset[i] = s.context
            extras = None
            if fn is self._chunk_first and self._extras_host is not None:
                extras = {k: v.to(self.device) for k, v in self._extras_host.items()}
            nxt, self.cache = self._launch(
                "prefill", fn, self._to_device(toks), self._to_device(offset),
                self._to_device(lens), self.cache, extras, series=series)
            nxt = nxt.cpu().numpy()
            self._prefill_s += time.perf_counter() - t0
            self._n_chunks += 1
            self._n_chunk_rows += len(group)
            for i in group:
                slot = self.slots[i]
                slot.filled += int(lens[i])
                slot.last_step = self._iter
                if slot.filled >= len(slot.prompt):
                    slot.state = "decode"
                    slot.pos = len(slot.prompt)
                    self._row_op(dcache.set_row_valid, i, True)
                    tok = int(nxt[i])
                    slot.last_token = tok
                    self._emit(i, tok)

    def _decode_step(self):
        """One batched per-row decode step over every decoding slot.  Rows
        not decoding ride along, parked at the position their own next
        prefill chunk overwrites first.  A decoding row that comes back
        non-finite is evicted (:meth:`_poisoned`) with its token
        suppressed; surviving rows snapshot on the ``snapshot_every``
        cadence."""
        t0 = time.perf_counter()
        toks = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        decoding = []
        for i, s in enumerate(self.slots):
            if s.state == "decode":
                toks[i, 0] = s.last_token
                pos[i] = s.pos
                decoding.append(i)
            else:  # park: overwritten by the slot's next prefill chunk
                pos[i] = s.context
        poison = np.zeros((self.max_batch,), bool)
        poison[self.injector.poison_rows(decoding)] = True
        nxt, ok, self.cache = self._launch(
            "decode", self._decode_rows, self._to_device(toks),
            self._to_device(pos), self.cache, self._to_device(poison))
        # the one host read of the step: tokens and validity together
        nxt, ok = torch.stack([nxt, ok.to(torch.int32)]).cpu().numpy()
        self._decode_s += time.perf_counter() - t0
        self._n_decode_steps += 1
        for i in decoding:
            if not ok[i]:
                self._poisoned(i)
                continue
            s = self.slots[i]
            s.pos += 1
            s.last_step = self._iter
            tok = int(nxt[i])
            s.last_token = tok
            if (not self._emit(i, tok) and self.snapshot_every
                    and len(s.req.out) % self.snapshot_every == 0):
                self._take_snapshot(i)

    def _apply_pressure(self):
        """Evict while the live-context total exceeds ``cache_budget`` and
        more than one slot is active.  The victim is the ``evict_policy``
        pick — ``largest``: the largest-context slot; ``coldest``: the
        least-recently-progressed slot by its ``last_step`` stamp.  Its
        request re-queues (resuming from its snapshot when it holds one).  A
        lone active slot never evicts."""
        if self.cache_budget is None:
            return
        while True:
            active = [(s.context, i) for i, s in enumerate(self.slots)
                      if s.state != "empty"]
            if (len(active) <= 1
                    or sum(c for c, _ in active) <= self.cache_budget):
                return
            if self.evict_policy == "coldest":
                _, victim = min((self.slots[i].last_step, i) for _, i in active)
            else:
                _, victim = max(active)
            req = self.slots[victim].req
            self.slots[victim] = _Slot()
            self.queue.append(req)
            self.scheduler.counters["pressure_evictions"] += 1

    # -- step API ------------------------------------------------------------
    def begin(self, requests: list[Request] = ()):
        """Start a serving run: reset per-run scheduler, cache and fault
        state and queue ``requests``.  ``begin``/``step``/``busy``/
        ``finish`` are the seam a fleet tier drives; :meth:`run` composes
        them for one replica."""
        for r in requests:
            self._check_extras(r)
        self.queue: list[Request] = list(requests)
        self.scheduler = SlotScheduler(self.max_batch)  # per-run telemetry
        self.slots = [_Slot() for _ in range(self.max_batch)]
        # this rank's rows (every row on one device)
        self._lo, self._hi, self._row_axes = self.rows(self.max_batch)
        self.cache = self.model.init_cache(self._hi - self._lo, self.max_len)
        self._completed: list[Request] = []
        self._n_chunks = self._n_decode_steps = self._n_chunk_rows = 0
        self._prefill_s = self._decode_s = 0.0
        # fault state is per-run: launch ordinals restart (a plan's decode@N
        # names the N-th launch of THIS run), the backoff rng re-seeds
        self._launch_seq = {"decode": 0, "prefill": 0}
        self._injected_before = self.injector.counters["faults_injected"]
        self._fault_rng = self.fault_policy.make_rng()
        self._snaps: dict[int, dict] = {}
        self._recent_faults: list[int] = []
        self.watchdog.reset()  # this run's shapes and cache kind, not the last run's
        self._iter = 0
        self._last_fault_iter = -(10 ** 9)
        self._active_limit = self.max_batch
        self.busy_s = 0.0
        self._t0 = time.perf_counter()

    def busy(self) -> bool:
        """True while queued requests or any occupied slot remain."""
        return bool(self.queue) or any(s.state != "empty" for s in self.slots)

    @torch.no_grad()
    def step(self):
        """One engine iteration: admit, batched prefill chunks, batched
        per-row decode, pressure eviction, degradation bookkeeping."""
        t0 = time.perf_counter()
        self._admit()
        self._advance_prefill()
        if any(s.state == "decode" for s in self.slots):
            self._decode_step()
        self._apply_pressure()
        self._update_degradation()
        self.busy_s += time.perf_counter() - t0

    def finish(self) -> dict:
        """Seal the run's counters and return :meth:`stats`."""
        self.scheduler.counters["faults_injected"] = (
            self.injector.counters["faults_injected"] - self._injected_before)
        return self.stats()

    def stats(self) -> dict:
        """Scheduler counters, fault counters, the degradation-window state,
        slot occupancy and the remaining-work load signal.  (The JAX
        engine's ``decode_compilations`` has no counterpart: nothing is
        compiled per shape here.)"""
        counters = self.scheduler.counters
        counters["faults_injected"] = (
            self.injector.counters["faults_injected"] - self._injected_before)
        faults = export_fault_counters(counters)
        return {
            "scheduler": {k: v for k, v in counters.items() if k not in faults},
            "faults": faults,
            "degradation": {
                "active_limit": self._active_limit,
                "max_batch": self.max_batch,
                "degraded": self._active_limit < self.max_batch,
                "recent_fault_events": len(self._recent_faults),
                "iter": self._iter,
            },
            "occupancy": {
                "queued": len(self.queue),
                "prefilling": sum(s.state == "prefill" for s in self.slots),
                "decoding": sum(s.state == "decode" for s in self.slots),
                "free": sum(s.state == "empty" for s in self.slots),
            },
            "work_remaining": self.work_remaining_total(),
            "launches": dict(self._launch_seq),
            "watchdog": self.watchdog.describe(),
            "busy_s": self.busy_s,
        }

    # -- request movement ----------------------------------------------------
    def work_remaining_total(self) -> int:
        """Queued + in-flight work remaining (the admission priority's
        units)."""
        w = sum(self._work_remaining(r) for r in self.queue)
        for s in self.slots:
            if s.req is not None:
                w += self._work_remaining(s.req, s.context)
        return w

    def drain_slot(self, i: int, fresh: bool = True) -> \
            tuple[Request, Optional[dict]]:
        """Release slot ``i`` and return ``(request, snapshot_or_None)``.  A
        live drain of a decoding row stages a FRESH snapshot first, so the
        request never rolls back; ``fresh=False`` (the death path) falls
        back to the last cadence snapshot or a full replay."""
        s = self.slots[i]
        req = s.req
        if fresh and s.state == "decode":
            self._take_snapshot(i)
        snap = self._snaps.pop(req.uid, None)
        self.slots[i] = _Slot()
        self.scheduler.counters["drains"] += 1
        return req, snap

    def withdraw_queued(self, qidx: int) -> tuple[Request, Optional[dict]]:
        """Remove queued request ``qidx`` with any snapshot it carries."""
        req = self.queue.pop(qidx)
        return req, self._snaps.pop(req.uid, None)

    def adopt(self, req: Request, snap: Optional[dict] = None):
        """Accept a request (with a host-staged snapshot, possibly taken on
        another engine of the same serving config, validated against this
        engine's cache before staging)."""
        self._check_extras(req)
        if snap is not None:
            dcache.snapshot_compatible(self.cache, snap["row"])
            self._snaps[req.uid] = snap
        self.queue.append(req)

    def salvage(self) -> list[tuple[Request, Optional[dict]]]:
        """Everything still owed: queued then slotted requests, each with
        its last host-staged snapshot.  Leaves the engine empty."""
        out = [(r, self._snaps.pop(r.uid, None)) for r in self.queue]
        self.queue = []
        for i, s in enumerate(self.slots):
            if s.req is not None:
                out.append(self.drain_slot(i, fresh=False))
        return out

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` to completion with continuous batching; greedy
        decode.  Per-request tokens land in ``request.out``.  Host wall
        times: ``prefill_s`` over the chunk launches (each ended by its host
        read), ``decode_s`` over the decode steps."""
        self.begin(requests)
        while self.busy():
            self.step()
        stats = self.finish()
        dt = time.perf_counter() - self._t0
        n_tokens = sum(len(r.out) for r in requests)
        return {
            "wall_s": dt,
            "busy_s": self.busy_s,
            "tokens": n_tokens,
            "tok_per_s": n_tokens / max(dt, 1e-9),
            "decode_steps": self._n_decode_steps,
            "prefill_chunks": self._n_chunks,
            "prefill_chunk_rows": self._n_chunk_rows,
            "decode_s": self._decode_s,
            "prefill_s": self._prefill_s,
            "completed": {r.uid: len(r.out) for r in self._completed},
            "telemetry": dict(self.scheduler.counters),
            "stats": stats,
        }


def check_lockstep_parity(engine: Engine, requests: list[Request]) -> bool:
    """Row-for-row acceptance check: each request run ALONE through the
    lockstep path (:meth:`Server.prefill`, :meth:`Server.decode`) must
    reproduce the engine's tokens exactly."""
    ok = True
    for r in requests:
        alone = Request(r.uid, r.prompt, max_new=r.max_new)
        tokens = torch.from_numpy(np.asarray(r.prompt, np.int32)[None]).to(engine.device)
        extras = {k: torch.as_tensor(v)[None].to(engine.device)
                  for k, v in (r.extras or {}).items()}
        logits, cache = engine.prefill(tokens, extras)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        for step in range(r.max_new):
            tok = int(nxt[0])
            alone.out.append(tok)
            if engine.eos_id is not None and tok == engine.eos_id:
                break
            if len(alone.out) >= r.max_new:
                break
            pos = torch.tensor(len(r.prompt) + step, dtype=torch.int32,
                               device=engine.device)
            nxt, cache = engine.decode(nxt[:, None], pos, cache)
        if alone.out != r.out:
            ok = False
            log.error("parity FAIL uid=%d alone=%s engine=%s", r.uid,
                      alone.out, r.out)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--prompt-align", type=int, default=1,
                    help="round generated prompt lengths up to a multiple "
                         "of N (ssm exactness needs chunk boundaries on "
                         "cfg.ssm_chunk multiples)")
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="total live context tokens across slots before "
                         "pressure eviction kicks in (0 = unbounded)")
    ap.add_argument("--evict-policy", default="largest",
                    choices=("largest", "coldest"),
                    help="pressure-eviction victim: largest context "
                         "(default) or coldest = least-recently-progressed")
    ap.add_argument("--check-lockstep", action="store_true",
                    help="re-run each request alone through the lockstep "
                         "path and check row-for-row token parity")
    ap.add_argument("--inject", default="",
                    help="deterministic fault plan, e.g. 'decode@12=raise,"
                         "prefill@3=delay:0.2,slot@2=nan_logits' (default: "
                         "the REPRO_FAULTS env plan)")
    ap.add_argument("--snapshot-every", type=int, default=16,
                    help="host-stage a row snapshot every N generated "
                         "tokens (0 = off)")
    ap.add_argument("--impl", default="",
                    help="execution-policy impl map (see serve.py docstring)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import init_from_env, make_debug_mesh

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    install_impl(args.impl)

    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    init_from_env(args.device)
    engine = Engine(cfg, mesh=make_debug_mesh(tp=2, device=args.device),
                    max_batch=args.slots, max_len=128,
                    chunk=args.chunk, cache_budget=args.cache_budget or None,
                    evict_policy=args.evict_policy,
                    injector=FaultInjector(args.inject) if args.inject else None,
                    snapshot_every=args.snapshot_every)
    rng = np.random.default_rng(0)

    def plen():
        n = int(rng.integers(4, 24))
        return -(-n // args.prompt_align) * args.prompt_align

    specs = engine.model.batch_extras_specs(1, 128)

    def mk_extras():
        # one random modality-frontend row per request (VLM/audio stubs), in
        # f32 as JAX draws it at f32 (the engine's buffer casts it)
        return {k: rng.standard_normal(sp.shape[1:]).astype(np.float32)
                for k, sp in specs.items()} or None

    reqs = [Request(i, rng.integers(3, cfg.vocab_size, plen()).astype(np.int32),
                    max_new=int(rng.integers(2, args.max_new + 1)), extras=mk_extras())
            for i in range(args.requests)]
    out = engine.run(reqs)
    print(f"served {out['tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s; {out['decode_steps']} decode "
          f"steps, {out['prefill_chunks']} prefill chunks) on {engine.device}")
    print(f"telemetry: {out['telemetry']}")
    if args.check_lockstep:
        if not check_lockstep_parity(engine, reqs):
            raise SystemExit("engine tokens diverge from the lockstep baseline")
        print("lockstep parity: OK")


if __name__ == "__main__":
    main()
