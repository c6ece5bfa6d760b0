"""Multi-replica serving router: the scheduler above the scheduler.  The port
of ``repro/launch/router.py``.

``Router`` fronts N :class:`~repro_torch.launch.engine.Engine` replicas
behind ONE request queue.  It knows each replica only through its
``Engine.stats()`` surface (load, occupancy, fault counters), never its
cache or device details, and moves requests between replicas through the
engine's host-staged row snapshots, so placement decisions are
resource-oblivious and token-exact.

**Routing arms** (``route=``):

* ``pws``: deterministic.  Admission runs through the same
  ``core.pws.match_round`` the engine's slot scheduler uses, with replicas
  as processors: each replica contributes one idle "intake lane" per unit
  of deficit (free admissible slots plus a small queue-depth allowance),
  ranked by ``(load, rid)``; queued requests are the stealable tasks at
  priority = work remaining.  The paper's bounds hold one level up and are
  ASSERTED: at most ``n_replicas - 1`` placements per matching round (Obs.
  4.3) and non-increasing round priorities within a drain (§4.1).
* ``rws``: seeded randomized two-choice: each placement samples two
  distinct replicas uniformly (``core.rws.two_choice``) and takes the
  lighter-loaded; a pick that lands on a replica with no intake capacity
  is a failed steal, retried next round.  The randomness perturbs
  *placement* only, never tokens: greedy decode is per-request
  deterministic whatever replica serves it.

**In-flight rebalancing.**  When the work-remaining skew between the most-
and least-loaded replicas crosses ``rebalance_threshold``, the router moves
one unit per round: a queued request if the donor has one, else a decoding
slot drained via ``Engine.drain_slot``; the request re-enters the recipient
through its host-staged snapshot (``models.cache`` row slices carry no slot
or replica identity; ``snapshot_compatible`` gates the hand-off).

**Replica loss.**  A replica whose step escalates ``LaunchFailedError`` is
marked dead: its queue and in-flight requests are salvaged (host memory
survives the device's loss; each rides with its last snapshot), re-queued
router-wide, and a replacement spins up through checkpoint-streamed
``Engine.restart`` on ``elastic.respawn_mesh``.  Replicas may also join
and leave live (:meth:`Router.add_replica` / :meth:`Router.remove_replica`):
joiners stream the same fleet checkpoint, leavers drain their requests back
through the snapshot path.

**Health and provenance.**  Each engine's fault counters fold into a
per-replica health score (``runtime.replica.health_score``); replicas under
the shed threshold stop receiving new placements unless the whole fleet is
shedding.  Each replica's provenance row (device, ``policy.describe()``,
its device's autotune table provenance, health, faults, seconds to spawn)
lands in the router's result.

**Fleet fault plans.**  ``fleet_faults`` takes ``|``-separated positional
per-replica plans (``runtime.fault_tolerance.parse_fleet_plan``):
``|decode@4=raise:99`` kills replica 1 only.  Respawned and joining
replicas always get a clean injector.

**Params and devices.**  Replica 0 takes ``params`` (a state dict) or,
without it, the engine's seeded weights, and writes the fleet checkpoint
(``checkpoint.save_checkpoint``, the JAX package's format, its manifest's
``mesh_shape`` the mesh's) under ``ckpt_dir`` (default: a new temporary
directory).  Every other replica, respawn and joiner comes up from that
checkpoint through :meth:`Engine.restart`.  Every replica runs on ``mesh``
(default: the ``(1, 1)`` mesh of ``device``, CUDA unless the caller passes
``"cpu"``): on one card they time-share it.

**Fleet clock.**  Replicas time-share one device, so the router steps them
round-robin and each engine accrues wall time on its own ``busy_s`` clock.
Were every replica its own card the rounds would overlap, so fleet
throughput is reported against the MAKESPAN ``max(busy_s)``
(``fleet_tok_per_s``) beside the sequential wall (``tok_per_s``), which on
one shared device cannot show the fleet's gain.  ``router_host_s`` is the
round time spent routing, rebalancing (a drained slot's snapshot
included) and refreshing health: the router's own cost, without the
engines' steps and without a dead replica's salvage and respawn (whose
``spawn_s`` its provenance row gives).

    python -m repro_torch.launch.router --reduced --device cpu --check-single
    python -m repro_torch.launch.router --reduced --device cpu --check-single \\
        --inject '|decode@4=raise:99' --min-restarts 1
    python -m repro_torch.launch.router --route rws --seed 5
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import pws, rws
from repro_torch.launch.engine import Engine
from repro_torch.launch.serve import Request, install_impl
from repro_torch.launch.mesh import axis_sizes, make_debug_mesh, mesh_for, refuse
from repro_torch.runtime.elastic import respawn_mesh
from repro_torch.runtime.fault_tolerance import (
    FAULT_PLAN_ENV,
    FaultInjector,
    LaunchFailedError,
    parse_fleet_plan,
)
from repro_torch.runtime.replica import Replica, spawn_replica

log = logging.getLogger("repro_torch.router")


class Router:
    """Data-parallel request router over N engine replicas (one request
    queue, two routing arms, snapshot migration, death -> checkpoint-streamed
    respawn).  See the module docstring for the contract."""

    def __init__(self, cfg, *, mesh=None, device=None, n_replicas: int = 2, route: str = "pws",
                 seed: int = 0, ckpt_dir=None, fleet_faults: str = "",
                 queue_depth: int = 1, rebalance_threshold: Optional[int] = None,
                 respawn: bool = True, params: Optional[dict] = None, **engine_kw):
        if route not in ("pws", "rws"):
            raise ValueError(f"unknown routing arm {route!r}: "
                             "expected 'pws' or 'rws'")
        self.mesh = mesh_for(mesh, device, "the router")
        refuse("the Router over multi-rank replicas", self.mesh)
        self.cfg = cfg
        self.route = route
        self.seed = int(seed)
        self.queue_depth = int(queue_depth)
        self.rebalance_threshold = rebalance_threshold
        self.respawn = respawn
        self._engine_kw = dict(engine_kw)
        self._work = Engine._work_remaining

        plans = parse_fleet_plan(fleet_faults, n_replicas)
        # replica 0 seeds the fleet checkpoint; every other replica (and every
        # respawn and join) spins up from it through Engine.restart, so all
        # replicas serve identical logits
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro-router-")
        self.replicas: list[Replica] = [
            spawn_replica(0, cfg, self.mesh, None, params=params,
                          injector=FaultInjector(plans[0]), **engine_kw)]
        self.device = self.replicas[0].engine.device
        t0 = time.perf_counter()
        save_checkpoint(self.ckpt_dir, 0, {"params": self.replicas[0].engine.model.state_dict()},
                        mesh_shape=axis_sizes(self.mesh))
        self.ckpt_save_s = time.perf_counter() - t0
        for rid in range(1, n_replicas):
            self.replicas.append(
                spawn_replica(rid, cfg, self.mesh, self.ckpt_dir,
                              injector=FaultInjector(plans[rid]), **engine_kw))
        self._by_rid = {r.rid: r for r in self.replicas}
        self._next_rid = n_replicas
        self.begin([])

    # -- fleet state ---------------------------------------------------------
    def _live(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == "live"]

    def _deficit(self, rep: Replica) -> int:
        """Intake capacity: free admissible slots plus the queue-depth
        allowance, minus requests already queued on the replica."""
        stats = rep.engine.stats()
        occ = stats["occupancy"]
        free = min(occ["free"], stats["degradation"]["active_limit"])
        return max(0, free + self.queue_depth - occ["queued"])

    def _candidates(self) -> list[Replica]:
        """Live replicas eligible for new placements: shedding removes
        unhealthy ones unless the WHOLE fleet is unhealthy (the last
        candidate is never shed: progress beats shedding)."""
        live = self._live()
        ok = [r for r in live if not r.shed()]
        if self.queue and ok and len(ok) < len(live):
            self.counters["sheds"] += len(live) - len(ok)
        return ok or live

    # -- run lifecycle -------------------------------------------------------
    def begin(self, requests: list[Request] = ()):
        """Start a fleet run: one global queue, fresh per-run counters, a
        re-seeded placement rng (same seed -> same placements), and a
        ``begin`` on every live replica."""
        self.queue: list[Request] = list(requests)
        uids = [r.uid for r in self.queue]
        assert len(set(uids)) == len(uids), "request uids must be unique"
        self.rng = random.Random(self.seed)
        self.placements: list[tuple[int, int]] = []
        self._snaps: dict[int, dict] = {}  # uid -> {"snap", "origin"}
        self.counters = {
            "route_rounds": 0, "failed_steals": 0, "sheds": 0,
            "queue_moves": 0, "slot_migrations": 0, "migrations": 0,
            "rebalances": 0, "replica_deaths": 0, "requeued_on_death": 0,
            "replica_restarts": 0, "joins": 0, "leaves": 0,
            "routed": {r.rid: 0 for r in self._live()},
        }
        for rep in self._live():
            rep.engine.begin([])
        self.rounds = 0
        self.router_host_s = 0.0
        self._t0 = time.perf_counter()

    def done(self) -> bool:
        return not self.queue and all(not r.engine.busy() for r in self._live())

    def step_round(self):
        """One fleet round: route, step every live busy replica once
        (catching escalated launch failures), rebalance, refresh health."""
        if not self._live():
            raise RuntimeError("no live replicas and respawn is off")
        t0 = time.perf_counter()
        self._route()
        host = time.perf_counter() - t0
        for rep in list(self.replicas):
            if rep.state != "live" or not rep.engine.busy():
                continue
            try:
                rep.engine.step()
            except LaunchFailedError as e:
                self._on_death(rep, e)
        t0 = time.perf_counter()
        self._rebalance()
        for rep in self._live():
            rep.refresh_health()
        self.rounds += 1
        self.router_host_s += host + time.perf_counter() - t0

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` across the fleet to completion; greedy decode.
        Per-request tokens land in ``request.out``, request-for-request
        identical to a clean single-replica run whatever the arm, the
        placement, the migrations or the deaths along the way."""
        self.begin(requests)
        while not self.done():
            self.step_round()
        return self.finish(requests)

    def finish(self, requests: list[Request]) -> dict:
        """Seal every live engine's counters and assemble the fleet view:
        router counters, the placement log, per-replica provenance rows,
        both throughput clocks (see "Fleet clock" in the module docstring)
        and the router's own host time."""
        for rep in self.replicas:
            if rep.state == "live":
                rep.engine.finish()
            rep.refresh_health()
        dt = time.perf_counter() - self._t0
        fleet = max((r.engine.busy_s for r in self.replicas), default=dt)
        n_tokens = sum(len(r.out) for r in requests)
        return {
            "wall_s": dt,
            "fleet_busy_s": fleet,
            "tokens": n_tokens,
            "tok_per_s": n_tokens / max(dt, 1e-9),
            "fleet_tok_per_s": n_tokens / max(fleet, 1e-9),
            "rounds": self.rounds,
            "router_host_s": self.router_host_s,
            "counters": {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in self.counters.items()},
            "placements": list(self.placements),
            "replicas": [{**rep.provenance(), "busy_s": rep.engine.busy_s}
                         for rep in self.replicas],
        }

    # -- routing arms --------------------------------------------------------
    def _place(self, req: Request, rid: int):
        entry = self._snaps.pop(req.uid, None)
        snap = entry["snap"] if entry else None
        if snap is not None and entry["origin"] != rid:
            # a snapshot taken on one replica resuming on another
            self.counters["migrations"] += 1
        self._by_rid[rid].engine.adopt(req, snap)
        self.counters["routed"][rid] = self.counters["routed"].get(rid, 0) + 1
        self.placements.append((req.uid, rid))

    def _route(self):
        if not self.queue:
            return
        if self.route == "pws":
            self._route_pws()
        else:
            self._route_rws()

    def _route_pws(self):
        """Deterministic arm: ``match_round`` over replicas-as-processors.
        Idle intake lanes rank by ``(load, rid, lane)`` (lighter replicas
        steal first), and the per-round placement bound and non-increasing
        priorities are asserted as in the engine's slot scheduler."""
        cands = self._candidates()
        bound = max(len(cands) - 1, 1)
        last_best: Optional[int] = None
        while self.queue:
            idle = []
            for rep in cands:
                load = rep.engine.work_remaining_total()
                for lane in range(self._deficit(rep)):
                    idle.append(((load, rep.rid, lane), rep.rid))
            if not idle:
                return
            heads = [(i, self._work(r)) for i, r in enumerate(self.queue)]
            best, pairs = pws.match_round(idle, heads)
            if best is None:
                return
            # Obs. 4.3 one level up: at most n_replicas - 1 placements of the
            # round's priority
            pairs = pairs[:bound]
            assert len(pairs) <= bound, \
                "router bounded-steals-per-round invariant violated"
            assert last_best is None or best <= last_best, \
                "router round priorities must be non-increasing"
            last_best = best
            self.counters["route_rounds"] += 1
            # pop in descending queue order so earlier indices stay valid
            for (_, rid), qidx in sorted(pairs, key=lambda p: -p[1]):
                self._place(self.queue.pop(qidx), rid)

    def _route_rws(self):
        """Randomized arm: the head of the queue (largest work remaining)
        placed by seeded two-choice over the candidates' loads; a pick
        without intake capacity is a failed steal, retried next round."""
        cands = self._candidates()
        while self.queue:
            if not any(self._deficit(r) > 0 for r in cands):
                return
            loads = {r.rid: r.engine.work_remaining_total() for r in cands}
            qidx = max(range(len(self.queue)),
                       key=lambda i: (self._work(self.queue[i]), -i))
            rid = rws.two_choice(self.rng, sorted(loads), loads)
            self.counters["route_rounds"] += 1
            if self._deficit(self._by_rid[rid]) <= 0:
                self.counters["failed_steals"] += 1
                return
            self._place(self.queue.pop(qidx), rid)

    # -- rebalancing ---------------------------------------------------------
    def _rebalance(self):
        """Move one unit of work per fleet round from the most- to the
        least-loaded replica while the skew exceeds the threshold."""
        if self.rebalance_threshold is None:
            return
        live = self._live()
        if len(live) < 2:
            return
        loads = {r.rid: r.engine.work_remaining_total() for r in live}
        donor = max(live, key=lambda r: (loads[r.rid], -r.rid))
        rec = min(live, key=lambda r: (loads[r.rid], r.rid))
        if loads[donor.rid] - loads[rec.rid] <= self.rebalance_threshold:
            return
        if self._move_one(donor, rec):
            self.counters["rebalances"] += 1

    def _move_one(self, donor: Replica, rec: Replica) -> bool:
        """One rebalance transfer: a queued request when the donor has one
        (no cache state moves), else the donor's heaviest decoding slot
        drained with a fresh snapshot (token-exact tail replay on the
        recipient).  Returns False when nothing is movable."""
        eng = donor.engine
        if eng.queue:
            qidx = max(range(len(eng.queue)),
                       key=lambda i: (self._work(eng.queue[i]), -i))
            req, snap = eng.withdraw_queued(qidx)
            kind = "queue_moves"
        else:
            if self._deficit(rec) <= 0:
                return False
            decode = [(self._work(s.req, s.context), -i, i)
                      for i, s in enumerate(eng.slots) if s.state == "decode"]
            if not decode:
                return False
            req, snap = eng.drain_slot(max(decode)[2])
            kind = "slot_migrations"
        if snap is not None:
            self._snaps[req.uid] = {"snap": snap, "origin": donor.rid}
        self.counters[kind] += 1
        self._place(req, rec.rid)
        return True

    # -- replica loss and elastic membership -----------------------------------
    def _on_death(self, rep: Replica, err: LaunchFailedError):
        """Salvage (host snapshots survive the device's loss), re-queue
        router-wide, respawn checkpoint-streamed."""
        rep.state = "dead"
        rep.refresh_health()
        self.counters["replica_deaths"] += 1
        salvaged = rep.engine.salvage()
        for req, snap in salvaged:
            if snap is not None:
                self._snaps[req.uid] = {"snap": snap, "origin": rep.rid}
            self.queue.append(req)
        self.counters["requeued_on_death"] += len(salvaged)
        log.warning("replica %d died (%s): %d request(s) re-queued fleet-wide",
                    rep.rid, err, len(salvaged))
        if self.respawn:
            self.add_replica(_counter="replica_restarts")

    def add_replica(self, mesh=None, *, _counter: str = "joins") -> Replica:
        """Elastic join (and the respawn path): spin a new replica from the
        fleet checkpoint through ``Engine.restart`` on ``mesh`` (default
        ``elastic.respawn_mesh`` of the fleet's mesh).  Joiners and respawns
        always get a clean injector."""
        rid = self._next_rid
        self._next_rid += 1
        rep = spawn_replica(rid, self.cfg, mesh or respawn_mesh(self.mesh),
                            self.ckpt_dir, injector=FaultInjector(""), **self._engine_kw)
        rep.engine.begin([])
        self.replicas.append(rep)
        self._by_rid[rid] = rep
        self.counters[_counter] += 1
        self.counters["routed"].setdefault(rid, 0)
        return rep

    def remove_replica(self, rid: int):
        """Elastic leave: drain everything the replica holds back into the
        router queue (in-flight decodes ride their snapshots and resume
        elsewhere token-exactly) and retire it from the fleet."""
        rep = self._by_rid[rid]
        if rep.state != "live":
            raise ValueError(f"replica {rid} is {rep.state}, not live")
        if len(self._live()) < 2:
            raise ValueError("cannot remove the last live replica")
        for req, snap in rep.engine.salvage():
            if snap is not None:
                self._snaps[req.uid] = {"snap": snap, "origin": rid}
            self.queue.append(req)
        rep.state = "left"
        self.counters["leaves"] += 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--route", default="pws", choices=("pws", "rws"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--evict-policy", default="largest", choices=("largest", "coldest"))
    ap.add_argument("--queue-depth", type=int, default=1)
    ap.add_argument("--rebalance-threshold", type=int, default=0,
                    help="work-remaining skew that triggers a migration "
                         "(0 = rebalancing off)")
    ap.add_argument("--inject", default="",
                    help="fleet fault plan: '|'-separated per-replica plans, "
                         "e.g. '|decode@4=raise:99' kills replica 1 "
                         "(default: the REPRO_FAULTS env plan)")
    ap.add_argument("--check-single", action="store_true",
                    help="re-serve the workload on a clean 1-replica engine with "
                         "replica 0's params and assert request-for-request token "
                         "identity")
    ap.add_argument("--min-restarts", type=int, default=0,
                    help="assert at least N checkpoint-streamed replica respawns "
                         "and at least one cross-replica migration")
    ap.add_argument("--impl", default="",
                    help="execution-policy impl map (see serve.py docstring)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    install_impl(args.impl)

    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    plan = args.inject or os.environ.get(FAULT_PLAN_ENV, "")
    engine_kw = dict(max_batch=args.slots, max_len=128, chunk=args.chunk,
                     snapshot_every=args.snapshot_every, evict_policy=args.evict_policy)
    rng = np.random.default_rng(0)
    spec = [(rng.integers(3, cfg.vocab_size, int(rng.integers(4, 24))).astype(np.int32),
             int(rng.integers(2, args.max_new + 1)))
            for _ in range(args.requests)]
    with tempfile.TemporaryDirectory(prefix="repro-router-") as ckpt_dir:
        mesh = make_debug_mesh(tp=2, device=args.device)
        router = Router(cfg, mesh=mesh, n_replicas=args.replicas, route=args.route,
                        seed=args.seed, ckpt_dir=ckpt_dir, fleet_faults=plan,
                        queue_depth=args.queue_depth,
                        rebalance_threshold=args.rebalance_threshold or None, **engine_kw)
        reqs = [Request(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
        out = router.run(reqs)
    print(f"served {out['tokens']} tokens across {len(out['replicas'])} replica row(s) "
          f"on {router.device}: fleet {out['fleet_tok_per_s']:.1f} tok/s (makespan "
          f"{out['fleet_busy_s']:.2f}s), sequential {out['tok_per_s']:.1f} tok/s "
          f"({out['wall_s']:.2f}s); router host time {out['router_host_s']:.4f}s over "
          f"{out['rounds']} rounds")
    print(f"router counters: {out['counters']}")
    for row in out["replicas"]:
        print(f"replica {row['rid']}: state={row['state']} from={row['spawned_from']} "
              f"health={row['health']:.2f} device={row['device']} policy={row['policy']}")
    if args.min_restarts:
        assert out["counters"]["replica_restarts"] >= args.min_restarts, \
            (f"expected >= {args.min_restarts} replica restart(s), got "
             f"{out['counters']['replica_restarts']}")
        assert out["counters"]["migrations"] >= 1, \
            "expected at least one cross-replica snapshot-resume migration"
    if args.check_single:
        single = Engine(cfg, mesh=mesh,
                        params=router.replicas[0].engine.model.state_dict(),
                        injector=FaultInjector(""), **engine_kw)
        alone = [Request(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
        single.run(alone)
        assert [r.out for r in alone] == [r.out for r in reqs], \
            "router tokens diverge from the clean single-replica run"
        print("single-replica token parity: OK")


if __name__ == "__main__":
    main()
