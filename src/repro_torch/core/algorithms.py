"""The paper's HBP algorithms as simulator programs (access-trace level).

Each program subclasses ``BPProgram`` and defines the global-array addresses
its tasks touch; the simulated machine (``repro_torch.core.machine``) replays them
under PWS/RWS and counts cache misses, block misses, steals per priority.

Programs here (Table 1):
  * MSum / MA           — scans (Type 1, f=1, L=1)
  * PrefixSums          — two-pass PS (Type 1 sequence)
  * MTBI                — matrix transpose in BI layout (f=1, L=1)
  * RMtoBI              — f=sqrt r reads, L=1 writes
  * BItoRMDirect        — f=sqrt r, L=sqrt r  (block misses!)
  * BItoRMGapped        — the gapping technique: hierarchical gaps kill
                          write-block sharing for tasks >= B log^2 B
  * StrassenSim         — Type 2 HBP with SEQ/FORK nodes (7-way recursion,
                          MA collections before/after, fresh temporaries =
                          limited access)

Value-level (numerically exact) twins live in ``algorithms_torch.py``.
The port's copy of ``repro/core/algorithms.py`` (pure Python and numpy).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import layouts
from repro_torch.core.hbp import BPProgram, Memory, Node


# ---------------------------------------------------------------------------
# Type 1: scans
# ---------------------------------------------------------------------------

class MSum(BPProgram):
    """Sum of A[0..n): the paper's M-Sum.  Output values stored in the
    in-order up-tree layout (§3.3) so up-pass writes never share blocks above
    level log B."""

    def __init__(self, n: int, mem: Memory, name: str = "msum",
                 input_base: int | None = None):
        self.mem = mem
        self.A = mem.alloc(f"{name}.A", n) if input_base is None else input_base
        self.S = mem.alloc(f"{name}.S", 2 * n)  # in-order layout sums
        self._inorder = layouts.inorder_positions(n)
        super().__init__(n, name)

    def _pos(self, node: Node) -> int:
        level = int(math.log2(max(node.size, 1)))
        idx = node.lo >> level
        return self._inorder[(level, idx)]

    def leaf_accesses(self, node: Node):
        return [(self.A + node.lo, False), (self.S + self._pos(node), True)]

    def up_accesses(self, node: Node):
        return [
            (self.S + self._pos(node.left), False),
            (self.S + self._pos(node.right), False),
            (self.S + self._pos(node), True),
        ]


class PSDistribute(BPProgram):
    """Second PS pass: distribute prefix offsets down the tree and write
    OUT[i] = offset_i + A[i].  Reads the in-order sums of a prior MSum."""

    def __init__(self, msum: MSum, mem: Memory, name: str = "psdist"):
        self.msum = msum
        self.OUT = mem.alloc(f"{name}.OUT", msum.n)
        super().__init__(msum.n, name)

    def head_accesses(self, node: Node):
        if node.is_leaf:
            return ()
        # read left child's subtree sum to pass offset to the right child
        return [(self.msum.S + self.msum._pos(node.left), False)]

    def leaf_accesses(self, node: Node):
        return [(self.msum.A + node.lo, False), (self.OUT + node.lo, True)]


def prefix_sums_programs(n: int, mem: Memory):
    m = MSum(n, mem)
    return [m, PSDistribute(m, mem)]


# ---------------------------------------------------------------------------
# Type 1: matrix programs (input size n^2; BP over the BI index space)
# ---------------------------------------------------------------------------

class MTBI(BPProgram):
    """In-place transpose of an n x n matrix in BI layout.  Leaf z with
    coords (r, c): if r < c, swap A[z] and A[z(c,r)]; else no-op.  Every
    address written once (limited access); subtree ranges are BI-contiguous
    (f = O(1)); the mirror range is touched by no other active task
    (L = O(1))."""

    def __init__(self, n_mat: int, mem: Memory, name: str = "mtbi"):
        self.n_mat = n_mat
        self.A = mem.alloc(f"{name}.A", n_mat * n_mat)
        super().__init__(n_mat * n_mat, name)

    def leaf_accesses(self, node: Node):
        z = node.lo
        r, c = layouts.bi_coords(np.asarray([z]))
        r, c = int(r[0]), int(c[0])
        if r >= c:
            return ()
        z2 = int(layouts.bi_index(np.asarray([c]), np.asarray([r]))[0])
        return [(self.A + z, False), (self.A + z2, False),
                (self.A + z, True), (self.A + z2, True)]


class RMtoBI(BPProgram):
    """BI[z] = RM[r,c]: contiguous writes (L=1), scattered reads (f=sqrt r)."""

    def __init__(self, n_mat: int, mem: Memory, name: str = "rm2bi"):
        self.n_mat = n_mat
        self.RM = mem.alloc(f"{name}.RM", n_mat * n_mat)
        self.BI = mem.alloc(f"{name}.BI", n_mat * n_mat)
        z = np.arange(n_mat * n_mat)
        r, c = layouts.bi_coords(z)
        self._rm_off = (r.astype(np.int64) * n_mat + c.astype(np.int64))
        super().__init__(n_mat * n_mat, name)

    def leaf_accesses(self, node: Node):
        z = node.lo
        return [(self.RM + int(self._rm_off[z]), False), (self.BI + z, True)]


class BItoRMDirect(BPProgram):
    """RM[r,c] = BI[z]: scattered WRITES -> L(r) = sqrt(r): concurrent tasks
    write into the same RM row blocks => block misses under stealing."""

    def __init__(self, n_mat: int, mem: Memory, name: str = "bi2rm"):
        self.n_mat = n_mat
        self.BI = mem.alloc(f"{name}.BI", n_mat * n_mat)
        self.RM = mem.alloc(f"{name}.RM", n_mat * n_mat)
        z = np.arange(n_mat * n_mat)
        r, c = layouts.bi_coords(z)
        self._rm_off = (r.astype(np.int64) * n_mat + c.astype(np.int64))
        super().__init__(n_mat * n_mat, name)

    def leaf_accesses(self, node: Node):
        z = node.lo
        return [(self.BI + z, False), (self.RM + int(self._rm_off[z]), True)]


def _hierarchical_gap_offset(c: np.ndarray, n: int) -> np.ndarray:
    """Column offset with the paper's hierarchical gaps: after every
    2^i-aligned segment (4 <= 2^i <= n), insert gap_for(2^i) empty words."""
    off = c.astype(np.int64).copy()
    i = 2
    while (1 << i) <= n:
        seg = 1 << i
        off += (c // seg).astype(np.int64) * layouts.gap_for(seg)
        i += 1
    return off


class BItoRMGapped(BPProgram):
    """BI->RM with the gapping technique (§3.2 'BI-RM (gap RM)'): the RM
    destination has hierarchical gaps so tasks of size >= ~B log^2 B share no
    write blocks.  A compaction scan (Type 1, f=L=1) follows."""

    def __init__(self, n_mat: int, mem: Memory, name: str = "bi2rmgap"):
        self.n_mat = n_mat
        n2 = n_mat * n_mat
        self.BI = mem.alloc(f"{name}.BI", n2)
        z = np.arange(n2)
        r, c = bi_r, bi_c = layouts.bi_coords(z)
        col_off = _hierarchical_gap_offset(np.arange(n_mat), n_mat)
        row_len = int(col_off[-1]) + 1 + layouts.gap_for(n_mat)
        row_off = _hierarchical_gap_offset(np.arange(n_mat), n_mat) * row_len
        self.row_len = row_len
        self.GAP = mem.alloc(f"{name}.GAP", int(row_off[-1]) + row_len + 1)
        self._dst = (row_off[r.astype(np.int64)] + col_off[c.astype(np.int64)])
        super().__init__(n2, name)

    def leaf_accesses(self, node: Node):
        z = node.lo
        return [(self.BI + z, False), (self.GAP + int(self._dst[z]), True)]


class CompactScan(BPProgram):
    """Compact the gapped array back to dense RM (a standard scan)."""

    def __init__(self, gapped: BItoRMGapped, mem: Memory, name: str = "compact"):
        self.g = gapped
        n2 = gapped.n
        self.RM = mem.alloc(f"{name}.RM", n2)
        n_mat = gapped.n_mat
        r, c = np.divmod(np.arange(n2), n_mat)
        col_off = _hierarchical_gap_offset(np.arange(n_mat), n_mat)
        row_off = _hierarchical_gap_offset(np.arange(n_mat), n_mat) * gapped.row_len
        self._src = row_off[r] + col_off[c]
        super().__init__(n2, name)

    def leaf_accesses(self, node: Node):
        i = node.lo
        return [(self.g.GAP + int(self._src[i]), False), (self.RM + i, True)]


def bi_to_rm_gapped_programs(n_mat: int, mem: Memory):
    g = BItoRMGapped(n_mat, mem)
    return [g, CompactScan(g, mem)]


# ---------------------------------------------------------------------------
# Type 2: Strassen (SEQ/FORK composite tree)
# ---------------------------------------------------------------------------

class CompositeProgram(BPProgram):
    """A program whose tree contains SEQ nodes (children run in order) in
    addition to binary fork nodes.  Used for Type >= 2 HBP computations.
    The machine executes SEQ nodes by running children sequentially."""

    def __init__(self, root: Node, n: int, name: str):
        self.n = n
        self.name = name
        self.root = root
        self._leaf_acc: dict[int, list] = {}
        self._up_acc: dict[int, list] = {}

    # access maps keyed by id(node)
    def leaf_accesses(self, node: Node):
        return self._leaf_acc.get(id(node), ())

    def up_accesses(self, node: Node):
        return self._up_acc.get(id(node), ())

    def priority(self, node: Node) -> int:
        return -node.depth


def _fork_tree(leaves: list[Node], depth: int, parent: Node | None) -> Node:
    """Binary fork tree over an arbitrary list of subtree roots."""
    if len(leaves) == 1:
        leaves[0].depth = depth
        leaves[0].parent = parent
        _renumber(leaves[0])
        return leaves[0]
    mid = (len(leaves) + 1) // 2
    node = Node(leaves[0].lo, leaves[-1].hi, depth, parent)
    node.left = _fork_tree(leaves[:mid], depth + 1, node)
    node.right = _fork_tree(leaves[mid:], depth + 1, node)
    node.left.parent = node
    node.right.parent = node
    return node


def _renumber(root: Node):
    stack = [root]
    while stack:
        v = stack.pop()
        seq = getattr(v, "seq_children", None)
        if seq is not None:
            # sequenced components stack their depth ranges so priorities
            # never recur across phases (see BPProgram.priority)
            d = v.depth + 1
            for ch in seq:
                ch.parent = v
                ch.depth = d
                _renumber(ch)
                d += _height(ch) + 1
        elif not v.is_leaf:
            v.left.depth = v.depth + 1
            v.right.depth = v.depth + 1
            stack.extend((v.left, v.right))


def _height(root: Node) -> int:
    cached = getattr(root, "_height_cache", None)
    if cached is not None:
        return cached
    seq = getattr(root, "seq_children", None)
    if seq is not None:
        h = sum(_height(ch) + 1 for ch in seq)
    elif root.is_leaf:
        h = 0
    else:
        h = 1 + max(_height(root.left), _height(root.right))
    root._height_cache = h  # type: ignore[attr-defined]
    return h


def _ma_tree(prog: CompositeProgram, dst: int, srcs: list[int], size: int,
             depth: int) -> Node:
    """BP tree computing dst[i] = combine(srcs[i]) for i in [0, size)."""

    def build(lo, hi, d, parent):
        node = Node(lo, hi, d, parent)
        if hi - lo > 1:
            mid = (lo + hi) // 2
            node.left = build(lo, mid, d + 1, node)
            node.right = build(mid, hi, d + 1, node)
        else:
            acc = [(s + lo, False) for s in srcs] + [(dst + lo, True)]
            prog._leaf_acc[id(node)] = acc
        return node

    return build(0, size, depth, None)


# Strassen products:  M1=(A11+A22)(B11+B22), M2=(A21+A22)B11, M3=A11(B12-B22),
# M4=A22(B21-B11), M5=(A11+A12)B22, M6=(A21-A11)(B11+B12), M7=(A12-A22)(B21+B22)
_STRASSEN_LHS = [(0, 3), (2, 3), (0,), (3,), (0, 1), (2, 0), (1, 3)]
_STRASSEN_RHS = [(0, 3), (0,), (1, 3), (2, 0), (3,), (0, 1), (2, 3)]
# C11 = M1+M4-M5+M7, C12 = M3+M5, C21 = M2+M4, C22 = M1-M2+M3+M6
_STRASSEN_OUT = [(0, 3, 4, 6), (2, 4), (1, 3), (0, 1, 2, 5)]


def strassen_program(n_mat: int, mem: Memory, base: int = 4) -> CompositeProgram:
    """Build the full Strassen HBP task tree (Type 2: c=1 collection of v=7
    subproblems of size m/4, MA collections before and after, all results in
    fresh arrays => limited access).  Matrices in BI layout, so quadrant q of
    a BI matrix of n^2 elements is the contiguous range [q*n^2/4, (q+1)*n^2/4)."""
    prog = CompositeProgram.__new__(CompositeProgram)
    prog._leaf_acc = {}
    prog._up_acc = {}
    prog.name = "strassen"
    prog.n = n_mat * n_mat

    A = mem.alloc("str.A", n_mat * n_mat)
    B = mem.alloc("str.B", n_mat * n_mat)
    C = mem.alloc("str.C", n_mat * n_mat)

    counter = [0]

    def rec(a: int, b: int, c: int, n: int, depth: int) -> Node:
        n2 = n * n
        if n <= base:
            # base-case MM as a BP tree over output elements
            def build(lo, hi, d, parent):
                node = Node(lo, hi, d, parent)
                if hi - lo > 1:
                    mid = (lo + hi) // 2
                    node.left = build(lo, mid, d + 1, node)
                    node.right = build(mid, hi, d + 1, node)
                else:
                    i, j = divmod(lo, n)
                    acc = [(a + i * n + kk, False) for kk in range(n)]
                    acc += [(b + kk * n + j, False) for kk in range(n)]
                    acc += [(c + lo, True)]
                    prog._leaf_acc[id(node)] = acc
                return node

            return build(0, n2, depth, None)

        q = n2 // 4  # BI quadrant stride
        Aq = [a + i * q for i in range(4)]
        Bq = [b + i * q for i in range(4)]
        Cq = [c + i * q for i in range(4)]
        counter[0] += 1
        tag = counter[0]

        pre: list[Node] = []
        lhs_bases, rhs_bases, t_bases = [], [], []
        for i in range(7):
            lb = mem.alloc(f"str.L{tag}.{i}", q)
            rb = mem.alloc(f"str.R{tag}.{i}", q)
            tb = mem.alloc(f"str.T{tag}.{i}", q)
            lhs_bases.append(lb)
            rhs_bases.append(rb)
            t_bases.append(tb)
            pre.append(_ma_tree(prog, lb, [Aq[k] for k in _STRASSEN_LHS[i]], q, 0))
            pre.append(_ma_tree(prog, rb, [Bq[k] for k in _STRASSEN_RHS[i]], q, 0))
        pre_root = _fork_tree(pre, 0, None)

        recs = [rec(lhs_bases[i], rhs_bases[i], t_bases[i], n // 2, 0)
                for i in range(7)]
        rec_root = _fork_tree(recs, 0, None)

        post = [_ma_tree(prog, Cq[j], [t_bases[k] for k in _STRASSEN_OUT[j]], q, 0)
                for j in range(4)]
        post_root = _fork_tree(post, 0, None)

        seq = Node(0, n2, depth, None)
        seq.seq_children = [pre_root, rec_root, post_root]  # type: ignore[attr-defined]
        for ch in seq.seq_children:  # type: ignore[attr-defined]
            ch.parent = seq
        return seq

    prog.root = rec(A, B, C, n_mat, 0)
    _renumber(prog.root)
    return prog


# ---------------------------------------------------------------------------
# Type 2: six-step FFT (structure-level: MT + sqrt(n) recursive FFTs + MT)
# ---------------------------------------------------------------------------

def fft_program(n: int, mem: Memory, base: int = 16) -> CompositeProgram:
    """The paper's FFT (§3.2): view length-n input as a sqrt(n) x sqrt(n)
    matrix (BI layout), transpose (MT), run sqrt(n) recursive FFTs of size
    sqrt(n) in parallel, twiddle-scale (a scan), transpose again.  Type 2
    HBP with c=2 collections of v=sqrt(n) subproblems of size sqrt(n).

    Access-trace level: the simulator counts the misses; the value-level
    twin is algorithms_torch.fft_six_step."""
    import math as _m

    prog = CompositeProgram.__new__(CompositeProgram)
    prog._leaf_acc = {}
    prog._up_acc = {}
    prog.name = "fft"
    prog.n = n
    X = mem.alloc("fft.X", n)

    def mt_tree(base_addr: int, m_side: int) -> Node:
        """BI transpose of an m_side x m_side region starting at base_addr."""
        n2 = m_side * m_side

        def build(lo, hi, d, parent):
            node = Node(lo, hi, d, parent)
            if hi - lo > 1:
                mid = (lo + hi) // 2
                node.left = build(lo, mid, d + 1, node)
                node.right = build(mid, hi, d + 1, node)
            else:
                z = lo
                r, c = layouts.bi_coords(np.asarray([z]))
                r, c = int(r[0]), int(c[0])
                if r < c:
                    z2 = int(layouts.bi_index(np.asarray([c]), np.asarray([r]))[0])
                    prog._leaf_acc[id(node)] = [
                        (base_addr + z, False), (base_addr + z2, False),
                        (base_addr + z, True), (base_addr + z2, True)]
            return node

        return build(0, n2, 0, None)

    def scan_tree(base_addr: int, size: int) -> Node:
        """Twiddle scale: read+write each element once (a BP scan)."""

        def build(lo, hi, d, parent):
            node = Node(lo, hi, d, parent)
            if hi - lo > 1:
                mid = (lo + hi) // 2
                node.left = build(lo, mid, d + 1, node)
                node.right = build(mid, hi, d + 1, node)
            else:
                prog._leaf_acc[id(node)] = [(base_addr + lo, False),
                                            (base_addr + lo, True)]
            return node

        return build(0, size, 0, None)

    def transpose_comp(base_addr: int, size: int) -> Node:
        """Square regions use the BI MT tree; rectangular splits fall back to
        a one-read-one-write pass (same f=O(1)/L=O(1) cost class in BI)."""
        m_side = int(_m.isqrt(size))
        if m_side * m_side == size:
            return mt_tree(base_addr, m_side)
        return scan_tree(base_addr, size)

    def rec(base_addr: int, size: int, depth: int) -> Node:
        if size <= base:
            return scan_tree(base_addr, size)  # base-case butterfly pass
        # view as rows x cols with cols = 2^ceil(log2(size)/2)
        cols = 1 << ((size.bit_length()) // 2)
        rows = size // cols
        subs1 = [rec(base_addr + i * cols, cols, 0) for i in range(rows)]
        subs2 = [rec(base_addr + i * rows, rows, 0) for i in range(cols)]
        seq = Node(0, size, depth, None)
        seq.seq_children = [  # type: ignore[attr-defined]
            transpose_comp(base_addr, size),
            _fork_tree(subs1, 0, None),
            scan_tree(base_addr, size),  # twiddles
            transpose_comp(base_addr, size),
            _fork_tree(subs2, 0, None),
            transpose_comp(base_addr, size),
        ]
        for ch in seq.seq_children:  # type: ignore[attr-defined]
            ch.parent = seq
        return seq

    prog.root = rec(X, n, 0)
    _renumber(prog.root)
    return prog


# ---------------------------------------------------------------------------
# Type 3: list ranking contraction phases with the paper's list gapping
# ---------------------------------------------------------------------------

def list_ranking_phase_programs(n: int, mem: Memory, *, gapped: bool = True):
    """The LR cost structure (§3.2/§4.6): geometric contraction phases; when
    the live list has size m = n/x^2 it is written in space n/x using every
    x-th location (the gapping), so once m <= n/B^2 no more block misses
    occur.  Each phase here is one BP pass over the live elements (the
    sort-free skeleton; SPMS cost shapes are validated in costmodel.py).

    Returns a list of BP programs (one per phase) sharing one array."""
    space = mem.alloc("lr.list", 2 * n)

    class PhaseProgram(BPProgram):
        def __init__(self, m: int, positions: np.ndarray, name: str):
            self.positions = positions
            super().__init__(m, name)

        def leaf_accesses(self, node: Node):
            p = int(self.positions[node.lo])
            return [(space + p, False), (space + p, True)]

    progs = []
    m = n
    while m >= 64:
        if gapped:
            pos = layouts.gapped_list_positions(m, n)
        else:
            pos = np.arange(m, dtype=np.int64)  # compact: adjacent phases share blocks
        progs.append(PhaseProgram(m, pos, f"lr_phase_{m}"))
        m //= 4  # a constant fraction eliminated per stage (paper: >= 1/3)
    return progs
