"""Replica lifecycle for the fleet tier: spawn, health, death, respawn.  The
port of ``repro/runtime/replica.py``.

A *replica* is one serving :class:`~repro_torch.launch.engine.Engine` plus
the bookkeeping the router (``repro_torch.launch.router``) needs: an id, a
live/dead/left state, how it was born (seeded init, or checkpoint-streamed
through :meth:`Engine.restart`), and a health score folded from the
engine's fault counters.  The engine is imported lazily, so
``repro_torch.runtime`` keeps no top-level dependency on
``repro_torch.launch``.

Health is signal-driven: :func:`health_score` reads the ``faults`` slice of
``Engine.stats()`` (``retries``, ``stragglers``, ``degradations``,
``degraded_iters``) and maps it into ``[0, 1]``.  The router sheds load
away from replicas under ``SHED_THRESHOLD``; the weights are sized so that
isolated stragglers never cross it while a degradation event or a retry
burst does.

A provenance row names the replica's ``device`` and, as JAX's, its
``mesh`` (``{axis: size}``), and carries JAX's ``autotune`` entry: the
replica's device's tuned-table provenance (``autotune.provenance``).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger("repro_torch.replica")

# health = 1 - sum(weight * counter), clamped to [0, 1].  Degradations are
# the strongest signal (the engine already judged the fault rate unhealthy);
# retries mean launches are failing; stragglers and degraded iterations are
# mild per-event evidence, so routine jitter stays above the shed bar.
HEALTH_WEIGHTS = {
    "retries": 0.15,
    "stragglers": 0.02,
    "degradations": 0.30,
    "degraded_iters": 0.01,
}
SHED_THRESHOLD = 0.5


def health_score(stats: dict) -> float:
    """Fold an ``Engine.stats()`` dict into one load-shedding signal in
    ``[0, 1]`` (1 = healthy).  Reads only the ``faults`` slice."""
    faults = stats.get("faults", {})
    score = 1.0
    for key, w in HEALTH_WEIGHTS.items():
        score -= w * float(faults.get(key, 0))
    return max(0.0, min(1.0, score))


@dataclass
class Replica:
    """One engine plus its fleet-side identity and state."""

    rid: int
    engine: object
    state: str = "live"            # live | dead | left
    spawned_from: str = "init"     # init | checkpoint
    health: float = 1.0
    stats: dict = field(default_factory=dict)
    spawn_s: float = 0.0           # host seconds to bring the engine up

    def refresh_health(self) -> float:
        """Re-read the engine's stats and fold them into ``health``."""
        self.stats = self.engine.stats()
        self.health = health_score(self.stats)
        return self.health

    def shed(self) -> bool:
        """True when the router should route new work away from here."""
        return self.health < SHED_THRESHOLD

    def provenance(self) -> dict:
        """This replica's row in the router telemetry: identity, device, the
        kernel policy and autotune table provenance (per replica: replicas
        on different device kinds replay different tables), the live health
        and fault picture, and the seconds its spawn took (a
        checkpoint-streamed restart's is what the fleet waits for when a
        replica dies)."""
        from repro_torch.kernels import autotune as kernel_autotune
        from repro_torch.kernels import policy as kernel_policy
        from repro_torch.launch.mesh import axis_sizes

        return {
            "rid": self.rid,
            "state": self.state,
            "spawned_from": self.spawned_from,
            "device": str(self.engine.device),
            "mesh": axis_sizes(self.engine.mesh),
            "policy": kernel_policy.current().describe(),
            "autotune": kernel_autotune.provenance(self.engine.device),
            "health": self.health,
            "faults": dict(self.stats.get("faults", {})),
            "spawn_s": self.spawn_s,
        }


def spawn_replica(rid: int, cfg, mesh=None, ckpt_dir=None, *, device=None,
                  **engine_kw) -> Replica:
    """Bring one replica up on ``mesh`` (default: the ``(1, 1)`` mesh of
    ``device``).  With ``ckpt_dir`` the spin-up is checkpoint-streamed
    (:meth:`Engine.restart`: the latest checkpoint's params through
    ``elastic.serving_restore`` onto the mesh), so every replica of a fleet
    serves the logits of the replica whose params were checkpointed.
    Without it the engine takes ``engine_kw``'s ``params``, else seeded
    weights (the fleet's replica 0, whose params seed the checkpoint)."""
    from repro_torch.launch.engine import Engine

    t0 = time.perf_counter()
    if ckpt_dir is None:
        rep = Replica(rid, Engine(cfg, mesh=mesh, device=device, **engine_kw))
    else:
        rep = Replica(rid, Engine.restart(cfg, ckpt_dir, mesh=mesh, device=device,
                                          **engine_kw),
                      spawned_from="checkpoint")
    rep.spawn_s = time.perf_counter() - t0
    log.info("replica %d up (%s, device %s)", rid, rep.spawned_from, rep.engine.device)
    return rep
