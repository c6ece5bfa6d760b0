"""Priority Work-Stealing matching round: the port's copy of
``repro.core.pws.match_round`` (paper §4.7), which the serving engine's
slot scheduler runs its admission rounds through.  The simulated machine's
``PWS`` scheduler stays in the JAX package."""
from __future__ import annotations


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
