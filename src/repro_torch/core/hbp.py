"""HBP computation IR (paper Definitions 3.2–3.5).

A ``BPProgram`` describes the *structure and memory-access pattern* of a BP
computation: a balanced binary forking tree whose nodes perform O(1) work in
the down-pass head, O(1) in the up-pass, with leaves of O(1) work.  Concrete
algorithms subclass it and define the addresses touched (reads/writes) at
each node against a ``Memory`` bump allocator.

HBP composition (Def. 3.4): ``Sequence`` runs components one after another
(Type max(t1,t2)); ``Recurse``-style composition is expressed by programs
that expand into collections (see algorithms.py).

Validation helpers check the paper's structural requirements:
  * balance condition (Def. 3.2 vi): |task at level i| in [c1*a^i*r, c2*a^i*r]
  * limited access (Def. 2.4): every writable address written O(1) times
  * O(1) computation per node

The port's copy of ``repro/core/hbp.py`` (pure Python).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional

Access = tuple[int, bool]  # (address, is_write)


class Memory:
    """Bump allocator over an abstract word-addressed memory.  The system
    property from §2.2 — core-requested space is block-aligned and disjoint —
    is enforced by aligning every allocation to the block size."""

    def __init__(self, block: int = 16):
        self.block = block
        self.top = 0
        self.regions: dict[str, tuple[int, int]] = {}

    def alloc(self, name: str, size: int) -> int:
        base = self.top
        self.regions[name] = (base, size)
        aligned = (size + self.block - 1) // self.block * self.block
        self.top += aligned
        return base


@dataclass
class Node:
    """One task in a BP tree.  ``lo..hi`` is the leaf range (size hi-lo)."""

    lo: int
    hi: int
    depth: int
    parent: Optional["Node"] = None
    left: Optional["Node"] = None
    right: Optional["Node"] = None
    join_count: int = 0
    frame_addr: int = -1  # assigned when the down-pass head executes
    stack_id: int = -1

    @property
    def size(self) -> int:
        return self.hi - self.lo

    @property
    def is_leaf(self) -> bool:
        return self.left is None


class BPProgram:
    """Base class: a single BP computation over ``n`` leaves (n power of 2).

    Subclasses override the access callbacks.  Sizes here are in leaves; the
    task size |tau| in words is proportional (each leaf touches O(1) words).
    """

    #: words of local variables per node frame (Def. 3.2 iv: O(1))
    frame_words: int = 2

    #: set by Machine.run_sequence so priorities never recur across sequenced
    #: components (Def. 3.4 case 4 + the Obs. 4.3 accounting)
    priority_offset: int = 0

    def __init__(self, n: int, name: str = "bp"):
        assert n > 0 and (n & (n - 1)) == 0, "n must be a power of two"
        self.n = n
        self.name = name
        self.root = self._build(0, n, 0, None)

    def _build(self, lo: int, hi: int, depth: int, parent) -> Node:
        node = Node(lo, hi, depth, parent)
        if hi - lo > 1:
            mid = (lo + hi) // 2
            node.left = self._build(lo, mid, depth + 1, node)
            node.right = self._build(mid, hi, depth + 1, node)
        return node

    # -- access callbacks (addresses in Memory space) -----------------------
    def head_accesses(self, node: Node) -> Iterable[Access]:
        return ()

    def leaf_accesses(self, node: Node) -> Iterable[Access]:
        return ()

    def up_accesses(self, node: Node) -> Iterable[Access]:
        return ()

    # -- padding (Def. 3.3) --------------------------------------------------
    def pad_words(self, node: Node) -> int:
        return 0

    # -- structural parameters ------------------------------------------------
    def nodes(self) -> Iterable[Node]:
        stack = [self.root]
        while stack:
            v = stack.pop()
            yield v
            if not v.is_leaf:
                stack.append(v.left)
                stack.append(v.right)

    def priority(self, node: Node) -> int:
        """PWS priority: -(DAG depth).  Strictly decreasing along any
        root-to-leaf path; in a balanced (H)BP computation all tasks at one
        priority have the same size to within a constant factor (§4.1/§4.2).
        Sequenced HBP components stack their depths (see algorithms.py and
        ``priority_offset``) so a priority never recurs across phases — the
        accounting behind Obs. 4.3's <= p-1 steals per priority."""
        return -node.depth - self.priority_offset


class PaddedBP(BPProgram):
    """Padded BP computation (Def. 3.3): each down-pass node declares an
    extra array of size sqrt(|tau|) on its execution stack."""

    def pad_words(self, node: Node) -> int:
        return int(math.isqrt(max(node.size, 1)))


@dataclass
class Sequence:
    """HBP sequencing (Def. 3.4, case 4): components run one after another,
    each itself a BPProgram or a Collection."""

    components: list
    name: str = "seq"


@dataclass
class Collection:
    """A BP/HBP collection: v parallel independent computations (generated by
    one level of parallel recursion).  The members are forked by a BP-like
    tree (paper §3.1 'Forking recursive tasks')."""

    members: list
    name: str = "coll"


# ---------------------------------------------------------------------------
# validators (paper's structural requirements)
# ---------------------------------------------------------------------------

def check_balance(prog: BPProgram, alpha: float = 0.5, c1: float = 0.5,
                  c2: float = 2.0) -> bool:
    """Def. 3.2 (vi): size of any task at level i within [c1 a^i r, c2 a^i r]."""
    r = prog.root.size
    for v in prog.nodes():
        bound = (alpha ** v.depth) * r
        if not (c1 * bound <= v.size <= c2 * bound):
            return False
    return True


def check_limited_access(prog: BPProgram, limit: int = 4) -> bool:
    """Def. 2.4: every writable address written O(1) (= ``limit``) times across
    the whole computation (global arrays; stack frames are reused space and
    are bounded separately by Lemma 3.1)."""
    writes: dict[int, int] = {}
    for v in prog.nodes():
        accesses = list(prog.head_accesses(v))
        accesses += list(prog.leaf_accesses(v)) if v.is_leaf else []
        accesses += list(prog.up_accesses(v)) if not v.is_leaf else []
        for addr, w in accesses:
            if w:
                writes[addr] = writes.get(addr, 0) + 1
                if writes[addr] > limit:
                    return False
    return True


def measure_cache_friendliness(prog: BPProgram, block: int) -> dict[int, float]:
    """Empirical f(r): for each task size r (per level), the max over tasks of
    (#distinct blocks touched) - |tau|/B, where |tau| = distinct words the
    task accesses (Def. 2.1: r words f-friendly if in O(r/B + f(r)) blocks)."""
    out: dict[int, float] = {}

    def footprint(v: Node) -> tuple[set[int], set[int]]:
        words: set[int] = set()
        blocks: set[int] = set()
        stack = [v]
        while stack:
            u = stack.pop()
            acc = list(prog.head_accesses(u))
            acc += list(prog.leaf_accesses(u)) if u.is_leaf else list(prog.up_accesses(u))
            for addr, _ in acc:
                words.add(addr)
                blocks.add(addr // block)
            if not u.is_leaf:
                stack.extend((u.left, u.right))
        return words, blocks

    level_nodes: dict[int, list[Node]] = {}
    for v in prog.nodes():
        level_nodes.setdefault(v.depth, []).append(v)
    for depth, nodes in level_nodes.items():
        r = nodes[0].size
        worst = 0.0
        for v in nodes[: 64]:  # sample
            words, blocks = footprint(v)
            worst = max(worst, len(blocks) - len(words) / block)
        out[r] = worst
    return out


def measure_block_sharing(prog: BPProgram, block: int) -> dict[int, int]:
    """Empirical L(r): for each level, the max number of blocks a task shares
    with its OFF-SUBTREE concurrent tasks (Def. 2.3).  Computed on global
    arrays (frames are per-execution)."""

    def blocks_of(v: Node) -> set[int]:
        blocks: set[int] = set()
        stack = [v]
        while stack:
            u = stack.pop()
            acc = list(prog.head_accesses(u))
            acc += list(prog.leaf_accesses(u)) if u.is_leaf else list(prog.up_accesses(u))
            for addr, _ in acc:
                blocks.add(addr // block)
            if not u.is_leaf:
                stack.extend((u.left, u.right))
        return blocks

    level_nodes: dict[int, list[Node]] = {}
    for v in prog.nodes():
        level_nodes.setdefault(v.depth, []).append(v)
    out: dict[int, int] = {}
    for depth, nodes in sorted(level_nodes.items()):
        if len(nodes) < 2:
            continue
        r = nodes[0].size
        sets = [blocks_of(v) for v in nodes[: 32]]
        worst = 0
        for i, s in enumerate(sets):
            shared = set()
            for j, t in enumerate(sets):
                if i != j:
                    shared |= (s & t)
            worst = max(worst, len(shared))
        out[r] = worst
    return out
