"""Simulated multicore (paper §2): p cores, private LRU caches of M words
with block size B, invalidation-based coherence, work-stealing execution of
BP/HBP programs.

The machine *counts* what the paper *bounds*:
  * cache misses (cold/capacity),
  * block misses (coherence invalidations — false sharing, Def. 2.2),
  * steals (per priority level — Obs. 4.3),
  * idle time and total virtual time.

Execution model: discrete-event, one heap event per core step.  Each step
executes one node phase (down-pass head + fork, leaf body, or up-pass join),
whose cost is the sum of its access costs (hit=1, any miss=b).  Work stealing
follows the plugged-in scheduler (PWS or RWS).  Execution stacks follow
§3.3: a stolen task's kernel allocates a fresh block-aligned stack; node
frames are pushed at the down-pass and the up-pass reads child frames —
space reuse across frames is what generates stack block misses, and padding
(Def. 3.3) spaces them out.

The port's copy of ``repro/core/machine.py`` (pure Python).
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict, defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.hbp import BPProgram, Memory, Node


class LRUCache:
    def __init__(self, n_blocks: int):
        self.capacity = max(n_blocks, 1)
        self.blocks: OrderedDict[int, bool] = OrderedDict()  # block -> dirty?

    def has(self, block: int) -> bool:
        return block in self.blocks

    def touch(self, block: int):
        self.blocks.move_to_end(block)

    def insert(self, block: int) -> Optional[int]:
        """Insert; returns evicted block or None."""
        self.blocks[block] = True
        self.blocks.move_to_end(block)
        if len(self.blocks) > self.capacity:
            evicted, _ = self.blocks.popitem(last=False)
            return evicted
        return None

    def invalidate(self, block: int):
        self.blocks.pop(block, None)


@dataclass
class Stats:
    cache_misses: list[int]
    block_misses: list[int]
    steals: list[tuple[float, int, int, int]] = field(default_factory=list)
    # (time, priority, thief, victim)
    steal_attempts: int = 0
    idle_time: float = 0.0
    finish_time: float = 0.0
    accesses: int = 0
    usurpations: int = 0

    def total_cache_misses(self) -> int:
        return sum(self.cache_misses)

    def total_block_misses(self) -> int:
        return sum(self.block_misses)

    def steals_per_priority(self) -> dict[int, int]:
        out: dict[int, int] = defaultdict(int)
        for _, pr, _, _ in self.steals:
            out[pr] += 1
        return dict(out)


class Machine:
    def __init__(self, p: int, M: int, B: int, *, miss_penalty: int = 4,
                 scheduler=None, padded: bool = False):
        self.p = p
        self.M = M
        self.B = B
        self.b = miss_penalty
        self.scheduler = scheduler
        self.padded = padded

        self.caches = [LRUCache(M // B) for _ in range(p)]
        self.holders: dict[int, set[int]] = defaultdict(set)  # block -> cores
        self.invalidated: list[set[int]] = [set() for _ in range(p)]
        self.stats = Stats([0] * p, [0] * p)

        # per-core state
        self.deques: list[deque] = [deque() for _ in range(p)]  # of Node
        self.current: list[Optional[tuple[Node, str, Node]]] = [None] * p
        # (node, phase "down"|"up", kernel_root)
        self.idle_since: list[Optional[float]] = [None] * p

        # execution stacks: stack_id -> [base, sp]
        self.stack_mem_top = 1 << 40  # stacks live far from global arrays
        self.stacks: list[list[int]] = []
        self.core_stack: list[int] = [-1] * p

        self.events: list[tuple[float, int, int]] = []  # (time, seq, core)
        self._seq = 0

    # -- memory ----------------------------------------------------------------
    def access(self, core: int, addr: int, is_write: bool) -> float:
        self.stats.accesses += 1
        block = addr // self.B
        cache = self.caches[core]
        cost = 1.0
        if cache.has(block):
            cache.touch(block)
        else:
            if block in self.invalidated[core]:
                self.stats.block_misses[core] += 1
                self.invalidated[core].discard(block)
            else:
                self.stats.cache_misses[core] += 1
            cost = float(self.b)
            evicted = cache.insert(block)
            self.holders[block].add(core)
            if evicted is not None:
                self.holders[evicted].discard(core)
        if is_write:
            for other in list(self.holders[block]):
                if other != core:
                    self.caches[other].invalidate(block)
                    self.holders[block].discard(other)
                    self.invalidated[other].add(block)
        return cost

    def _access_all(self, core: int, accesses) -> float:
        t = 0.0
        for addr, w in accesses:
            t += self.access(core, addr, w)
        return t

    # -- stacks (paper §3.3) ------------------------------------------------------
    def new_stack(self) -> int:
        base = self.stack_mem_top
        self.stack_mem_top += 1 << 20  # block-aligned, disjoint
        self.stacks.append([base, base])
        return len(self.stacks) - 1

    def push_frame(self, stack_id: int, words: int) -> int:
        base, sp = self.stacks[stack_id]
        addr = sp
        self.stacks[stack_id][1] = sp + words
        return addr

    def pop_frame(self, stack_id: int, addr: int, words: int):
        # LIFO pop when possible (delayed pops under usurpation are benign
        # for the counting experiments)
        base, sp = self.stacks[stack_id]
        if addr + words == sp:
            self.stacks[stack_id][1] = addr

    # -- execution ---------------------------------------------------------------
    def run_sequence(self, programs, *, max_steps: int = 50_000_000) -> Stats:
        """Run an HBP sequence (Def. 3.4 case 4): components one after
        another; caches persist, stats accumulate, and priorities are offset
        per component so they never recur (Obs. 4.3 accounting)."""
        offset = 0
        for prog in programs:
            prog.priority_offset = offset
            offset += int(math.ceil(math.log2(max(prog.n, 2)))) + 2
            self.run(prog, max_steps=max_steps)
        return self.stats

    def run(self, prog: BPProgram, *, max_steps: int = 50_000_000) -> Stats:
        self.prog = prog
        sched = self.scheduler
        sched.reset(self)

        # core 0 begins the root kernel
        sid = self.new_stack()
        self.core_stack[0] = sid
        self.current[0] = (prog.root, "down", prog.root)
        self._push_event(0.0, 0)
        for c in range(1, self.p):
            self.idle_since[c] = 0.0
            sched.on_idle(self, c, 0.0)

        steps = 0
        while self.events and steps < max_steps:
            t, _, core = heapq.heappop(self.events)
            steps += 1
            if self.current[core] is not None:
                dt = self._step(core, t)
                if self.current[core] is not None:
                    self._push_event(t + dt, core)
                else:
                    nxt = self._take_own(core)
                    if nxt is not None:
                        self.current[core] = (nxt, "down", nxt)
                        self._push_event(t + dt, core)
                    else:
                        self.idle_since[core] = t + dt
                        sched.on_idle(self, core, t + dt)
                self.stats.finish_time = max(self.stats.finish_time, t + dt)
            # round boundary (paper §4.1): steal matching happens only after
            # every core's activity at this timestamp has been processed, so
            # forks made "now" are visible to the round's priority scan
            if not self.events or self.events[0][0] > t:
                sched.flush(self, t)
        return self.stats

    def _push_event(self, t: float, core: int):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, core))

    def _take_own(self, core: int) -> Optional[Node]:
        if self.deques[core]:
            return self.deques[core].pop()  # bottom
        return None

    def assign_stolen(self, core: int, node: Node, t: float):
        """Scheduler calls this when a steal completes."""
        sid = self.new_stack()
        self.core_stack[core] = sid
        self.current[core] = (node, "down", node)
        if self.idle_since[core] is not None:
            self.stats.idle_time += t - self.idle_since[core]
            self.idle_since[core] = None
        self._push_event(t, core)

    def steal_from(self, victim: int) -> Optional[Node]:
        if self.deques[victim]:
            return self.deques[victim].popleft()  # head (top)
        return None

    def head_priority(self, victim: int) -> Optional[int]:
        if self.deques[victim]:
            return self.prog.priority(self.deques[victim][0])
        return None

    def _step(self, core: int, t: float) -> float:
        prog = self.prog
        node, phase, kernel_root = self.current[core]
        dt = 0.0
        if phase == "down":
            # allocate frame on this core's current stack
            words = prog.frame_words + (prog.pad_words(node) if self.padded else 0)
            node.frame_addr = self.push_frame(self.core_stack[core], words)
            node.stack_id = self.core_stack[core]
            dt += self._access_all(core, [(node.frame_addr, True),
                                          (node.frame_addr + 1, True)])
            dt += self._access_all(core, prog.head_accesses(node))
            seq = getattr(node, "seq_children", None)
            if seq is not None:
                node.seq_index = 0  # type: ignore[attr-defined]
                self.current[core] = (seq[0], "down", kernel_root)
            elif node.is_leaf:
                dt += self._access_all(core, prog.leaf_accesses(node))
                self.current[core] = (node, "up", kernel_root)
            else:
                self.deques[core].append(node.right)  # bottom
                self.scheduler.on_task_available(self, core, t)
                self.current[core] = (node.left, "down", kernel_root)
        else:  # up
            parent = node.parent
            if parent is None:
                self.current[core] = None  # whole program complete
            elif getattr(parent, "seq_children", None) is not None:
                # HBP sequencing: advance to the next component in order
                parent.seq_index += 1  # type: ignore[attr-defined]
                seq = parent.seq_children  # type: ignore[attr-defined]
                if parent.seq_index < len(seq):
                    self.current[core] = (seq[parent.seq_index], "down", kernel_root)
                else:
                    dt += self._access_all(core, prog.up_accesses(parent))
                    self.current[core] = (parent, "up", kernel_root)
            else:
                parent.join_count += 1
                if parent.join_count == 2:
                    # the later finisher continues up — a usurpation when the
                    # parent frame lives on another kernel's stack (Def. 4.1)
                    dt += self._access_all(
                        core,
                        [(parent.left.frame_addr, False),
                         (parent.right.frame_addr, False),
                         (parent.frame_addr, True)],
                    )
                    dt += self._access_all(core, prog.up_accesses(parent))
                    if parent.stack_id != self.core_stack[core]:
                        self.stats.usurpations += 1
                    self.current[core] = (parent, "up", kernel_root)
                else:
                    self.current[core] = None  # suspend this path
        return max(dt, 1.0)
