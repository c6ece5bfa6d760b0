"""Randomized two-choice placement: the port's copy of
``repro.core.rws.two_choice``, which the fleet router's ``rws`` arm runs
every placement through.  It draws from a ``random.Random`` exactly as the
JAX package does, so one seed gives the same picks in both.

The simulated machine's ``RWS`` scheduler class (an idle core steals the
head of a uniformly random victim's deque, retrying after one time unit)
stays in the JAX package until the simulator core is ported (ROADMAP queue
1 item 8).
"""
from __future__ import annotations

import random


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
