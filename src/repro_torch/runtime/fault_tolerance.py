"""Fault tolerance: fault injection, bounded retry, straggler detection.
The port's copy of ``repro/runtime/fault_tolerance.py``, the fleet
grammar ``parse_fleet_plan`` that the router reads included.

The engine (``repro_torch.launch.engine``) maps the failure taxonomy onto
launches: (a) a launch that exhausts its retries raises
:class:`LaunchFailedError` for a job-level restart, (b) a transient launch
fault retries under :class:`FaultPolicy`'s bounded backoff, and (c)
straggler launches are flagged by :class:`StragglerMonitor` z-scores, one
series per kind of launch (:class:`LaunchWatchdog`), and feed the engine's
graceful-degradation window.

Faults fire deterministically from a declarative plan
(:class:`FaultInjector`, ``REPRO_FAULTS``); the one sanctioned source of
nondeterminism is the seeded retry-backoff jitter, which perturbs wall time
only, never the recovered output.

The trainer (``repro_torch.launch.train``) wraps each step in
:class:`FaultTolerantRunner`: bounded retry of a failed step, periodic
async checkpoints, and :class:`StragglerMonitor` over the step times.
"""
from __future__ import annotations

import logging
import os
import statistics
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

log = logging.getLogger(__name__)

FAULT_PLAN_ENV = "REPRO_FAULTS"

# The engine's fault-telemetry counter names, in one place so every consumer
# slices the same keys out of the scheduler's counter dict.
FAULT_COUNTER_KEYS = (
    "retries", "faults_injected", "slots_poisoned", "snapshots_taken",
    "snapshot_restores", "stragglers", "degradations", "degraded_iters",
)


def export_fault_counters(counters: dict) -> dict:
    """The fault-tolerance slice of an engine's telemetry counters (missing
    keys read as 0)."""
    return {k: counters.get(k, 0) for k in FAULT_COUNTER_KEYS}


def parse_fleet_plan(plan: str, n_replicas: int) -> list[str]:
    """Split a fleet fault plan into per-replica engine plans.  The fleet
    grammar is ``plan[|plan...]``: ``|``-separated positional per-replica
    plans (position = replica id, missing tails empty), e.g.
    ``|decode@4=raise:99`` faults replica 1 only.  A plan with no ``|``
    applies to EVERY replica, as a single engine's plan would.  Each piece
    is validated through :func:`parse_fault_plan`; a plan naming more
    replicas than the router has raises ``ValueError``."""
    if "|" in plan:
        pieces = [p.strip() for p in plan.split("|")]
        if len(pieces) > n_replicas:
            raise ValueError(
                f"fleet fault plan names {len(pieces)} replicas but the "
                f"router has {n_replicas}")
        pieces += [""] * (n_replicas - len(pieces))
    else:
        pieces = [plan] * n_replicas
    for piece in pieces:
        parse_fault_plan(piece)
    return pieces


class InjectedFault(RuntimeError):
    """A fault raised by :class:`FaultInjector` (distinguishable from real
    failures in logs; handled identically by the retry machinery)."""


class LaunchFailedError(RuntimeError):
    """A launch exhausted its bounded retries — the serving analogue of a
    hard step failure, escalated for job-level restart."""

    def __init__(self, kind: str, ordinal: int, attempts: int):
        super().__init__(
            f"{kind} launch {ordinal} failed after {attempts} attempt(s)")
        self.kind = kind
        self.ordinal = ordinal
        self.attempts = attempts


@dataclass
class FaultSpec:
    """One parsed fault-plan entry.

    ``kind``     ``decode`` | ``prefill`` (``index`` = per-run launch
                 ordinal) or ``slot`` (``index`` = engine slot id).
    ``action``   ``raise`` (fail the launch; ``arg`` = consecutive attempts
                 to fail, default 1), ``delay`` (sleep before the launch —
                 a straggler; ``arg`` = seconds, default 0.05), or
                 ``nan_logits`` (poison the slot's logits; ``arg`` = fire on
                 the n-th decode launch in which the slot is decoding,
                 default 1).
    """

    kind: str
    index: int
    action: str
    arg: float
    remaining: float = field(default=0.0)

    def __post_init__(self):
        # 'raise' burns one count per failed attempt; the others fire once
        # after 'arg' eligible launches (delay is immediate: count 1)
        self.remaining = self.arg if self.action == "raise" else (
            self.arg if self.action == "nan_logits" else 1)


_KINDS = ("decode", "prefill", "slot")
_ACTIONS = ("raise", "delay", "nan_logits")
_DEFAULT_ARG = {"raise": 1, "delay": 0.05, "nan_logits": 1}


def parse_fault_plan(plan: str) -> list[FaultSpec]:
    """Parse the declarative grammar
    ``kind@index=action[:arg][,kind@index=action[:arg]...]``, e.g.
    ``decode@12=raise,prefill@3=delay:0.2,slot@2=nan_logits``."""
    specs: list[FaultSpec] = []
    for raw in filter(None, (e.strip() for e in plan.split(","))):
        try:
            target, action = raw.split("=", 1)
            kind, index = target.split("@", 1)
            arg = None
            if ":" in action:
                action, arg_s = action.split(":", 1)
                arg = float(arg_s)
        except ValueError as e:
            raise ValueError(f"malformed fault-plan entry {raw!r} "
                             "(want kind@index=action[:arg])") from e
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                             f"(want one of {_KINDS})")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} in {raw!r} "
                             f"(want one of {_ACTIONS})")
        if action == "nan_logits" and kind != "slot":
            raise ValueError(f"{raw!r}: nan_logits targets a slot")
        if action in ("raise", "delay") and kind == "slot":
            raise ValueError(f"{raw!r}: {action} targets a launch "
                             "(decode/prefill)")
        specs.append(FaultSpec(kind, int(index), action,
                               _DEFAULT_ARG[action] if arg is None else arg))
    return specs


class FaultInjector:
    """Deterministic, plan-driven fault source.

    The plan (see :func:`parse_fault_plan`; ``REPRO_FAULTS`` env) names
    exactly which launches fail, which straggle, and which slot's logits go
    non-finite — so a faulted run is reproducible end to end and its
    recovered output can be asserted token-identical to the clean run.  The
    seed jitters only the injected delay's duration.
    """

    def __init__(self, plan: str = "", seed: int = 0):
        self.plan = plan
        self.specs = parse_fault_plan(plan)
        self.rng = np.random.default_rng(seed)
        self.counters = {"faults_injected": 0}

    @classmethod
    def from_env(cls, seed: int = 0) -> "FaultInjector":
        """An injector for the ``REPRO_FAULTS`` plan (empty plan = no-op)."""
        return cls(os.environ.get(FAULT_PLAN_ENV, ""), seed=seed)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def describe(self) -> str:
        return self.plan or "none"

    def before_launch(self, kind: str, ordinal: int) -> None:
        """Fire any ``raise``/``delay`` fault planned for this launch.
        Raises :class:`InjectedFault` BEFORE the launch writes anything, so
        a bounded retry of the same arguments is sound; a ``delay`` sleeps
        in the launch's timed window so the straggler watchdog sees it."""
        for spec in self.specs:
            if (spec.kind != kind or spec.index != ordinal
                    or spec.remaining <= 0):
                continue
            if spec.action == "raise":
                spec.remaining -= 1
                self.counters["faults_injected"] += 1
                raise InjectedFault(f"injected: {kind} launch {ordinal}")
            if spec.action == "delay":
                spec.remaining -= 1
                self.counters["faults_injected"] += 1
                time.sleep(spec.arg * (1.0 + 0.1 * self.rng.random()))

    def poison_rows(self, decoding_slots) -> list[int]:
        """Slot ids whose logits must go non-finite on THIS decode launch:
        each ``slot@i=nan_logits:n`` entry counts down one per decode launch
        in which slot ``i`` is decoding and fires on the n-th."""
        out = []
        for spec in self.specs:
            if (spec.kind != "slot" or spec.action != "nan_logits"
                    or spec.remaining <= 0 or spec.index not in decoding_slots):
                continue
            spec.remaining -= 1
            if spec.remaining <= 0:
                self.counters["faults_injected"] += 1
                out.append(spec.index)
        return out


@dataclass(frozen=True)
class FaultPolicy:
    """Bounded-retry policy: up to ``max_retries`` in-place retries with
    exponential backoff and seeded jitter, which perturbs wall time and
    never the recovered output."""

    max_retries: int = 2
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        """Sleep before retry ``attempt`` (0-based): exponential base times
        a seeded multiplicative jitter in [1, 1 + jitter)."""
        base = self.backoff_s * (self.backoff_mult ** attempt)
        return base * (1.0 + self.jitter * float(rng.random()))


@dataclass
class StragglerMonitor:
    """Rolling per-launch time stats; flags launches slower than mean +
    k*std.  Flagged samples are EXCLUDED from the rolling window, so a
    genuine straggler does not inflate the std and mask the next one."""

    window: int = 50
    k_sigma: float = 3.0
    min_samples: int = 10
    times: list[float] = field(default_factory=list)
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this sample is a straggler."""
        ts = self.times
        if len(ts) >= self.min_samples:
            mean = sum(ts) / len(ts)
            var = sum((t - mean) ** 2 for t in ts) / len(ts)
            if dt > mean + self.k_sigma * max(var ** 0.5, 1e-9):
                self.flagged += 1
                return True  # outlier: keep it OUT of the window stats
        ts.append(dt)
        if len(ts) > self.window:
            ts.pop(0)
        return False


# The engine's watchdog (:class:`LaunchWatchdog`): each series' rolling
# window, the deviations a straggler must pass, the samples a series needs
# before it judges, and the multiple of the series' median that a straggler
# must also pass.
WATCHDOG_WINDOW = 32
WATCHDOG_K_SIGMA = 4.0
WATCHDOG_MIN_SAMPLES = 5
WATCHDOG_FLOOR = 4.0


@dataclass
class LaunchWatchdog:
    """The engine's straggler watchdog: one :class:`StragglerMonitor` per
    series of like launches (decode steps, first prefill chunks,
    continuation chunks), cleared per serving run (:meth:`reset`).

    A launch's time is its host wall time, so on the card it is the host's
    enqueue of the step's kernels, and of its device time where the launch
    queue fills.  One series over every kind mixed chunks that take several
    decode steps' time into the decode steps' statistics, and a run's
    samples into the next run's (another cache, other shapes): unfaulted
    runs on the card flagged both.  Within one series the host's own noise
    still passes ``WATCHDOG_K_SIGMA`` deviations of a tight window now and
    then (up to 2.02 times the median in unfaulted runs on an H100 host), so
    a time at or below ``WATCHDOG_FLOOR`` times the series' median joins the
    window unflagged, and only a longer one is z-scored."""

    series: dict = field(default_factory=dict)
    peak_ratio: dict = field(default_factory=dict)

    def observe(self, series: str, dt: float) -> bool:
        """Returns True if this sample is a straggler of its series."""
        mon = self.series.get(series)
        if mon is None:
            mon = self.series[series] = StragglerMonitor(
                WATCHDOG_WINDOW, WATCHDOG_K_SIGMA, WATCHDOG_MIN_SAMPLES)
        ts = mon.times
        if len(ts) >= mon.min_samples:
            ratio = dt / max(statistics.median(ts), 1e-12)
            self.peak_ratio[series] = max(self.peak_ratio.get(series, 0.0), ratio)
            if ratio <= WATCHDOG_FLOOR:
                ts.append(dt)
                if len(ts) > mon.window:
                    ts.pop(0)
                return False
        return mon.observe(dt)

    def reset(self) -> None:
        self.series.clear()
        self.peak_ratio.clear()

    def describe(self) -> dict:
        """Per series: samples kept, launches flagged, the window's median
        (ms) and the largest time over the median seen when judged."""
        return {name: {"kept": len(m.times), "flagged": m.flagged,
                       "median_ms": 1e3 * statistics.median(m.times) if m.times else None,
                       "peak_over_median": self.peak_ratio.get(name)}
                for name, m in self.series.items()}


class UpdateStartedError(RuntimeError):
    """A training step failed after it began to update its state in place
    (``launch/steps.py``): the state may hold part of the update, so
    :class:`FaultTolerantRunner` does not retry it."""


class FaultTolerantRunner:
    """Wraps a training loop's step with bounded retry and periodic
    checkpoints (JAX ``fault_tolerance.py:274-321``)::

        runner = FaultTolerantRunner(ckpt_manager, save_every=100)
        state, start = runner.restore_or(state)
        for step in range(start, total):
            state = runner.run_step(step, lambda: train_step(state, batch))

    ``ckpt_manager`` is a ``repro_torch.checkpoint.CheckpointManager``, or
    None for retry and straggler detection without checkpoints;
    ``mesh_shape``, the trainer's mesh as ``{axis: size}``, goes into each
    manifest, as in JAX.  ``lockstep`` (the ranks of a sharded mesh)
    retries only an :class:`InjectedFault`, which fires on every rank at
    the same step; any other failure is raised at once.

    One point differs from JAX, whose step returns new arrays and leaves its
    inputs untouched, so that any failed step can run again.  The port's
    step updates the parameters and the AdamW state in place
    (``optim/adamw.py``), and a retry of a step whose update had begun would
    apply part of it twice.  So a step marks that boundary: a failure it
    raises before the update (the forward, the backward, the gradient norm)
    is retried, up to ``max_retries`` times; one after the update began
    comes as :class:`UpdateStartedError`, which the runner passes on after
    waiting for any pending save, leaving the restart from the last
    checkpoint to the job, as JAX does when a step is out of retries.  The
    periodic save runs after the step has succeeded and outside the retry,
    so an error from it (a failed earlier async write) is raised, never
    taken for a step failure."""

    def __init__(self, ckpt_manager=None, *, save_every: int = 100, max_retries: int = 2,
                 mesh_shape: Optional[dict] = None, lockstep: bool = False):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_retries = max_retries
        # ranks of a sharded mesh retry only faults that fire on every rank
        # together (InjectedFault, by step); any other failure raises at
        # once, and the other ranks raise through the group's timeout
        self.lockstep = lockstep
        self.mesh_shape = mesh_shape or {}
        self.monitor = StragglerMonitor()
        self.retries = 0

    def restore_or(self, state_init: Any) -> tuple[Any, int]:
        """The latest checkpoint restored into ``state_init``'s own tensors
        and the step after it, or ``(state_init, 0)`` when there is none."""
        if self.ckpt is None:
            return state_init, 0
        try:
            step, state = self.ckpt.restore_latest(state_init, in_place=True)
        except FileNotFoundError:
            return state_init, 0
        log.info("restored checkpoint at step %d", step)
        return state, step + 1

    def wait(self) -> None:
        if self.ckpt is not None:
            self.ckpt.wait()

    def run_step(self, step: int, step_fn: Callable[[], Any]) -> Any:
        """Run one step with bounded retry; checkpoint on schedule.
        ``step_fn`` closes over whatever state it needs and returns the
        state to checkpoint."""
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                new_state = step_fn()
            except UpdateStartedError:
                self.wait()
                raise
            except Exception as e:  # noqa: BLE001 -- deliberate: retry any step fault
                if self.lockstep and not isinstance(e, InjectedFault):
                    raise
                # the failed attempt's frames would hold its tensors (a whole
                # set of gradients) through the retry: keep the error, not them
                traceback.clear_frames(e.__traceback__)
                last_exc = e
                self.retries += 1
                log.warning("step %d attempt %d failed: %r", step, attempt, e)
                continue
            dt = time.perf_counter() - t0
            if self.monitor.observe(dt):
                log.warning("straggler step %d: %.3fs", step, dt)
            if self.ckpt is not None and self.save_every and (step + 1) % self.save_every == 0:
                self.ckpt.save_async(step, new_state, self.mesh_shape)
            return new_state
        # out of retries: persist what we have and re-raise for a job restart
        self.wait()
        raise RuntimeError(f"step {step} failed after {self.max_retries} retries") from last_exc
