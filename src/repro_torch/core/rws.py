"""Randomized two-choice placement: the port's copy of
``repro.core.rws.two_choice``, which the fleet router's ``rws`` arm runs
every placement through.  It draws from a ``random.Random`` exactly as the
JAX package does, so one seed gives the same picks in both.

The simulated machine's :class:`RWS` scheduler (Randomized Work Stealing,
the baseline the paper compares against: an idle core picks a victim
uniformly at random and steals the head, largest, task of its deque; on
failure it retries after one time unit) sits beside it, as in JAX's
``repro/core/rws.py``.
"""
from __future__ import annotations

import random
from typing import Optional


def two_choice(rng: random.Random, ids, load) -> int:
    """Sample two DISTINCT ids uniformly from ``ids`` and return the
    lighter-loaded one by ``load[id]``, ties to the lower id.  With a single
    candidate there is nothing to choose between and no draw is made.  The
    randomness moves where a request lands, never its tokens."""
    ids = list(ids)
    if len(ids) == 1:
        return ids[0]
    i = rng.randrange(len(ids))
    j = rng.randrange(len(ids) - 1)
    if j >= i:
        j += 1
    a, b = ids[i], ids[j]
    return a if (load[a], a) <= (load[b], b) else b


class RWS:
    def __init__(self, seed: int = 0, steal_cost: Optional[float] = None):
        self.seed = seed
        self.steal_cost = steal_cost

    def reset(self, machine):
        self.rng = random.Random(self.seed)
        self.sp = self.steal_cost if self.steal_cost is not None else float(machine.b)
        self.waiting: list[tuple[float, int]] = []

    def on_idle(self, machine, core: int, t: float):
        self._attempt(machine, core, t)

    def on_task_available(self, machine, core: int, t: float):
        pass

    def flush(self, machine, t: float):
        # retry any waiting thieves
        waiting, self.waiting = self.waiting, []
        for since, thief in waiting:
            self._attempt(machine, thief, max(since, t))

    def _attempt(self, machine, thief: int, t: float):
        machine.stats.steal_attempts += 1
        victim = self.rng.randrange(machine.p)
        if victim == thief:
            victim = (victim + 1) % machine.p
        node = machine.steal_from(victim)
        if node is not None:
            pr = machine.prog.priority(node)
            machine.stats.steals.append((t, pr, thief, victim))
            machine.assign_stolen(thief, node, t + self.sp)
        else:
            self.waiting.append((t + 1.0, thief))
