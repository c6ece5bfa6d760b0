"""Priority Work-Stealing (paper §4): the port's copy of
``repro/core/pws.py``.

:func:`match_round` is the §4.7 distributed-matching round, which the
serving engine's slot scheduler, the fleet router's ``pws`` arm and the
simulated machine's :class:`PWS` scheduler all run their rounds through,
so the three share one copy of the rule.

Deterministic: steals proceed in rounds of non-increasing priority
(priority = -depth, so larger tasks first — the size-based BFS order).  In
each round, idle cores are matched BY RANK to the available head tasks of
the round's priority; a steal costs s_P = b * ceil(log2 p) (the two
O(log p)-step tree phases of the distributed implementation).

Properties the tests verify empirically (they are theorems in the paper):
  * at most p-1 tasks of any priority are stolen (Obs. 4.3);
  * steal priorities are non-increasing over time within a BP computation;
  * total steal attempts <= 2 p D' (Cor. 4.1).
"""
from __future__ import annotations

import math
from typing import Optional


def match_round(idle, heads):
    """One §4.7 distributed-matching round, as data: ``idle`` is a list of
    ``(rank, thief)`` pairs (rank = arrival order; ties by thief index) and
    ``heads`` a list of ``(victim, priority-or-None)`` queue heads.  Returns
    ``(best_priority, [(idle_pair, victim), ...])`` — the idle entries sorted
    by rank matched positionally to the victims holding the round's (max)
    priority, victims by index — or ``(None, [])`` when nothing is stealable.

    In the serving engine (``repro_torch.launch.engine.SlotScheduler``)
    requests are tasks, idle decode slots are thieves, and priority = work
    remaining.  The caller owns the round-boundary rules (the bounded-steals
    cap in the engine)."""
    live = [(v, pr) for v, pr in heads if pr is not None]
    if not live or not idle:
        return None, []
    best = max(pr for _, pr in live)
    victims = [v for v, pr in live if pr == best]
    return best, list(zip(sorted(idle), victims))


class PWS:
    def __init__(self, steal_cost: Optional[float] = None):
        self.steal_cost = steal_cost

    def reset(self, machine):
        self.idle: list[tuple[float, int]] = []  # (since, core)
        self.sp = self.steal_cost if self.steal_cost is not None else (
            machine.b * max(math.ceil(math.log2(max(machine.p, 2))), 1)
        )

    def on_idle(self, machine, core: int, t: float):
        self.idle.append((t, core))

    def on_task_available(self, machine, core: int, t: float):
        pass  # matching happens at round boundaries (flush)

    def flush(self, machine, t: float):
        if self.idle:
            self._match(machine, t)

    def _match(self, machine, t: float):
        """Match idle cores to the highest-priority queue heads (round order).

        Paper §4.1/§4.7: a round with priority d only concludes when every
        non-idle core has generated a task on its queue; a busy core with an
        empty queue advertises (its current priority - 1) as an upper bound
        on the task it may yet generate, and the round DEFERS if that bound
        exceeds the best available head."""
        while self.idle:
            # the round's priority and pairing via the shared §4.7 round
            heads = [(v, machine.head_priority(v)) for v in range(machine.p)]
            best, pairs = match_round(self.idle, heads)
            if best is None:
                return
            # advertised upper bounds from busy cores with empty queues
            for c in range(machine.p):
                if machine.current[c] is not None and not machine.deques[c]:
                    node = machine.current[c][0]
                    adv = machine.prog.priority(node) - 1
                    if adv > best:
                        return  # round priority not yet determined — wait
            matched = 0
            for (since, thief), v in pairs:
                node = machine.steal_from(v)
                if node is None:
                    continue  # failed steal: thief stays idle for next round
                self.idle.remove((since, thief))
                machine.stats.steal_attempts += 1
                machine.stats.steals.append((t, best, thief, v))
                machine.assign_stolen(thief, node, max(t, since) + self.sp)
                matched += 1
            if matched == 0:
                return
