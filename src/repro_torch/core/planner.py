"""The PWS planner: the counterpart of ``repro/core/planner.py``, the
paper's Priority Work-Stealing scheduler realized as a *static* sharding
planner for SPMD meshes.

Why this is PWS: for *balanced* HBP computations the paper proves the PWS
schedule is deterministic: steals happen in priority (= size, BFS) order
and at most p-1 tasks are stolen per priority level (Obs. 4.3).  On a
lockstep SPMD machine that schedule collapses to a static breadth-first
partition of the top log2(p) fork levels, which this module performs:

  * every parameter / activation / cache tensor is an HBP task tree whose
    fork levels are its axes (largest first = highest priority);
  * mesh axes are the "cores"; assigning a tensor axis to a mesh axis is
    the (deterministic, priority-ordered) steal of that fork level;
  * an axis whose mesh size does not divide it stays unsharded (only
    balanced forks are stolen).

The planner reads a mesh's axis names and sizes only, so every function
takes a real ``DeviceMesh`` or an :class:`~repro_torch.launch.mesh.AbstractMesh`.
Specs are :class:`PartitionSpec`: one entry per tensor dim, each a mesh
axis, a tuple of axes, or None.  :func:`named` turns a spec tree into
DTensor placements (``Shard`` / ``Replicate``) on a mesh, and
:func:`place` puts tensors where a plan says: on a mesh of more than one
rank it cuts each to this rank's block and tags it with its
:class:`Placement` (the dense family executes sharded, ``launch/mesh.py``),
:func:`gather` gives the whole tensors back, and :func:`row_block` is a
batch's rows under ``plan_batch``'s rule.

The port holds one module per layer where JAX stacks layers along leading
axes.  A rule is keyed on the JAX leaf name that
``checkpoint._repro_name`` gives a port name (``layers.3.wq`` ->
``layers/wq`` -> ``wq``), and a per-layer leaf's spec is JAX's spec of the
stacked leaf without its leading stack entries.  The cache layouts
(``LinearKV``, ``RingKV``, ``CrossKV``, ``StateCarry``) are planned by
their fields: k/v slabs by the KV rule of JAX's docstring (JAX's own
``plan_cache`` never reaches that rule for its dataclass layouts and
replicates every slab: ``ROADMAP.md`` queue 3), state leaves by their
``states`` key exactly as JAX does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes, mesh_device

# the H100's numbers for the tall-cache check (JAX: a TPU v5e's VMEM, lane
# and sublane): the shared memory one thread block may hold, 227 KB (CUDA C++
# Programming Guide, "Technical Specifications per Compute Capability",
# 9.0), and the 128-byte cache line a global access moves (CUDA C++ Best
# Practices Guide, "Coalesced Access to Global Memory")
SMEM_BYTES = 227 * 1024
LINE_BYTES = 128


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or None
    (``jax.sharding.PartitionSpec``, whose normalization it keeps: a tuple
    of one name is that name, an empty tuple is None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshAxes:
    """Names of the mesh axes by role."""

    dp: tuple[str, ...]  # data-parallel axes (outermost first), e.g. ("pod","data")
    fsdp: str  # axis that also shards parameters/optimizer (ZeRO)
    tp: str  # tensor/model-parallel axis

    @property
    def all_dp(self) -> tuple[str, ...]:
        return self.dp


def axes_for(mesh) -> MeshAxes:
    if "pod" in axis_names(mesh):
        return MeshAxes(dp=("pod", "data"), fsdp="data", tp="model")
    return MeshAxes(dp=("data",), fsdp="data", tp="model")


def tall_cache_ok(block_bytes: int = LINE_BYTES) -> bool:
    """The paper's tall-cache condition M >= B^2 with M a block's shared
    memory and B one cache line (JAX's expression, the H100's numbers)."""
    return (SMEM_BYTES >= (block_bytes ** 2) ** 0.5 * block_bytes ** 0.5
            or SMEM_BYTES >= block_bytes * 64)


# ---------------------------------------------------------------------------
# trees: nested dicts and the cache layouts (dataclasses)
# ---------------------------------------------------------------------------

def tree_items(tree, path: str = ""):
    """``(path, leaf)`` for every tensor or spec leaf of ``tree``, paths
    written as ``jax.tree_util.keystr`` writes them (``['kv'].k``,
    ``.states['conv']``); dict keys in sorted order, a layout's fields in
    declaration order; None, ints and bools are not leaves."""
    if isinstance(tree, PartitionSpec) or isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], f"{path}[{key!r}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_items(getattr(tree, f.name), f"{path}.{f.name}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor / spec leaves of ``tree`` (and the matching
    leaves of ``rest``), keeping its structure."""
    if isinstance(tree, (PartitionSpec, torch.Tensor)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), (PartitionSpec, torch.Tensor, dict))})
    return tree


# ---------------------------------------------------------------------------
# parameter sharding rules (PWS priority order: biggest axes stolen first)
# ---------------------------------------------------------------------------
# rule: leaf-name -> PartitionSpec entries for the TRAILING dims of the leaf.
# Leading (layer-stack) dims are padded with None.

def _param_rules(ax: MeshAxes) -> dict[str, tuple]:
    fsdp, tp = ax.fsdp, ax.tp
    return {
        # embeddings: vocab over tp (vocab-parallel), d over fsdp
        "embed": (tp, fsdp),
        "lm_head": (tp, fsdp),
        # projections (in, out): column-parallel -> out over tp, in over fsdp
        "wq": (fsdp, tp), "wk": (fsdp, tp), "wv": (fsdp, tp),
        "w_gate": (fsdp, tp), "w_up": (fsdp, tp),
        "w_x": (fsdp, tp), "w_gate_branch": (fsdp, tp), "w_in": (fsdp, tp),
        "w_mlp_gate": (fsdp, tp), "w_mlp_up": (fsdp, tp),
        # row-parallel (in over tp, out over fsdp)
        "wo": (tp, fsdp), "w_down": (tp, fsdp), "w_out": (tp, fsdp),
        "w_mlp_down": (tp, fsdp),
        # biases follow the column dim
        "bq": (tp,), "bk": (tp,), "bv": (tp,),
        # router stays replicated over tp (it is tiny and every shard needs it)
        "router": (fsdp, None),
        # experts: expert axis over tp (EP), d over fsdp; gapped slabs
        "e_gate": (tp, fsdp, None), "e_up": (tp, fsdp, None),
        "e_down": (tp, None, fsdp),
        # conv / recurrent params: width over tp
        "conv_w": (None, tp),
        "lru_a_gate": (None, None, None), "lru_i_gate": (None, None, None),
        "lru_a_param": (tp,),
        "A_log": (tp,), "dt_bias": (tp,), "D": (tp,), "gn": (tp,),
        # norms / scalar gates: replicated
        "ln": (None,), "ln1": (None,), "ln2": (None,), "ln3": (None,),
        "final_norm": (None,), "enc_norm": (None,),
        "q_norm": (None,), "k_norm": (None,),
        "xgate_attn": (), "xgate_ffn": (),
    }


def leaf_name(port_name: str) -> tuple[str, int]:
    """A port parameter name (or a flattened state path) -> (the JAX leaf
    name its rule is keyed on, the number of stacked axes JAX gives it):
    ``layers.3.wq`` -> (``wq``, 1), ``self_layers.1.2.wq`` -> (``wq``, 2),
    ``decoder.0.self_attn.wq`` -> (``wq``, 1), ``embed`` -> (``embed``, 0)."""
    from repro_torch.checkpoint import _repro_name

    name, layer = _repro_name(port_name)
    return name.rpartition("/")[2], len(layer or ())


def _divides(dim: int, axis, sizes: dict) -> bool:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[a]
    return dim % size == 0


def _param_spec(name: str, shape, rules: dict, sizes: dict) -> PartitionSpec:
    leaf, stacked = leaf_name(name)
    ndim = len(shape)
    rule = tuple(rules.get(leaf, (None,) * (ndim + stacked)))
    # JAX aligns the rule with the stacked leaf's trailing dims; the port's
    # per-layer leaf is that leaf without its ``stacked`` leading dims
    entries = ((None,) * (ndim + stacked - len(rule)) + rule)[stacked:]
    return P(*(None if axis is None or not _divides(dim, axis, sizes) else axis
               for dim, axis in zip(shape, entries)))


def plan_params(params: Any, mesh, mode: str = "fsdp") -> Any:
    """PartitionSpec tree for a parameter tree: the port's state dict, or
    nested dicts of them (an AdamW state's ``master`` / ``m`` / ``v``),
    leaves by leaf-name rules.  Dims that do not divide evenly by the mesh
    axis are left unsharded (the paper's balance condition).

    mode="fsdp" (ZeRO-3): weights 2D-sharded (fsdp x tp): per-layer weight
    all-gathers, minimum memory.  mode="zero1": weights tp-sharded only
    (replicated across data); the optimizer state stays fsdp-sharded by the
    caller."""
    if mode not in ("fsdp", "zero1"):
        raise ValueError(f"unknown param sharding mode {mode!r}: expected 'fsdp' or 'zero1'")
    ax = axes_for(mesh)
    sizes = axis_sizes(mesh)
    rules = _param_rules(ax)
    if mode == "zero1":
        rules = {name: tuple(None if a == ax.fsdp else a for a in rule)
                 for name, rule in rules.items()}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return _param_spec(prefix[:-1], tuple(tree.shape), rules, sizes)

    return walk(params, "")


def plan_opt_state(opt_state: Any, mesh) -> dict:
    """Specs of an AdamW state ``{"step", "master", "m", "v"}``: the step
    replicated, the rest as :func:`plan_params` in fsdp mode (JAX's
    ``train.build_training`` and ``elastic.replan_for_mesh``)."""
    out = {"step": P()}
    for key in ("master", "m", "v"):
        out[key] = plan_params(opt_state[key], mesh)
    return out


def plan_batch(batch: Any, mesh) -> Any:
    """Batch sharding: leading batch dim over all dp axes when divisible;
    a batch of one shards its sequence axis instead."""
    ax = axes_for(mesh)
    sizes = axis_sizes(mesh)
    dp_size = 1
    for a in ax.dp:
        dp_size *= sizes[a]

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if shape[0] % dp_size == 0 and shape[0] > 0:
            return P(ax.dp, *(None,) * (len(shape) - 1))
        # long-context single-batch: shard the sequence axis instead
        if len(shape) >= 2 and shape[1] % dp_size == 0:
            return P(None, ax.dp, *(None,) * (len(shape) - 2))
        return P(*(None,) * len(shape))

    return tree_map(spec_for, batch)


_KV_NAMES = {"k", "v", "xk", "xv", "img_k", "img_v"}


def _kv_spec(shape, ax: MeshAxes, dp_size: int, tp_size: int) -> PartitionSpec:
    """JAX's KV rule on trailing dims (b, S, kvh, hd)."""
    nd = len(shape)
    entries: list = [None] * nd
    b_i, s_i, h_i = nd - 4, nd - 3, nd - 2
    if shape[b_i] % dp_size == 0:
        entries[b_i] = ax.dp
        if shape[h_i] % tp_size == 0:
            entries[h_i] = ax.tp
        elif shape[s_i] % tp_size == 0:
            entries[s_i] = ax.tp
    else:
        # batch=1 long context: sequence over (dp..., tp) as divisible
        if shape[s_i] % (dp_size * tp_size) == 0:
            entries[s_i] = ax.dp + (ax.tp,)
        elif shape[s_i] % dp_size == 0:
            entries[s_i] = ax.dp
        elif shape[s_i] % tp_size == 0:
            entries[s_i] = ax.tp
    return P(*entries)


def _state_spec(name: str, shape, ax: MeshAxes, dp_size: int, tp_size: int) -> PartitionSpec:
    """JAX's rules for a named cache leaf that is not a KV slab."""
    nd = len(shape)
    entries: list = [None] * nd
    if name == "ssm":  # (L, b, nh, hp, ds)
        if shape[nd - 4] % dp_size == 0:
            entries[nd - 4] = ax.dp
        if shape[nd - 3] % tp_size == 0:
            entries[nd - 3] = ax.tp
    elif name.startswith("lru"):  # (n, b, w)
        if shape[nd - 2] % dp_size == 0:
            entries[nd - 2] = ax.dp
        if shape[nd - 1] % tp_size == 0:
            entries[nd - 1] = ax.tp
    elif name.startswith("conv"):  # (L, b, k-1, w)
        if shape[nd - 3] % dp_size == 0:
            entries[nd - 3] = ax.dp
        if shape[nd - 1] % tp_size == 0:
            entries[nd - 1] = ax.tp
    return P(*entries)


def plan_cache(cache: Any, mesh) -> Any:
    """KV/state cache sharding, the cache's structure with a spec for each
    tensor.

    KV slabs (the ``k`` / ``v`` of ``LinearKV``, ``RingKV`` and ``CrossKV``)
    are (..., b, S, kvh, hd): b over dp when divisible; kv-heads over tp
    when divisible, else S over tp (sequence parallelism: a flash-decode
    style partial-softmax combine over tp).  For b == 1 (long context), S
    over dp as well.  State leaves (a ``StateCarry``'s ``states``: ssm /
    lru / conv) shard their width/head axis over tp, by their key, as in
    JAX; a key that matches no rule (``tail_conv``, ``tail_lru``) and every
    other tensor (``pos``, int8 scales, ``valid``) stays replicated."""
    ax = axes_for(mesh)
    sizes = axis_sizes(mesh)
    tp_size = sizes[ax.tp]
    dp_size = 1
    for a in ax.dp:
        dp_size *= sizes[a]

    def named_leaf(name, leaf):
        shape = tuple(leaf.shape)
        if name in _KV_NAMES:
            return _kv_spec(shape, ax, dp_size, tp_size)
        return _state_spec(name, shape, ax, dp_size, tp_size)

    def walk(tree, name):
        if isinstance(tree, torch.Tensor):
            return named_leaf(name, tree)
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                f.name: walk(getattr(tree, f.name), f.name)
                for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), (torch.Tensor, dict))})
        return tree

    return walk(cache, "")


# ---------------------------------------------------------------------------
# from specs to placements and bytes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``).  ``placements``:
    one DTensor placement per mesh dim, ``Shard(i)`` where tensor dim ``i``
    names that mesh axis, else ``Replicate()``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in axis_names(self.mesh):
            dims = [i for i, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named(tree_of_specs: Any, mesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), tree_of_specs)


def shard_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n = 1
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def shard_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, ``meta`` ones too)
    placed by ``specs``: JAX's ``argument_size_in_bytes`` of the same
    arrays under the same shardings."""
    total = 0

    def add(leaf, spec):
        nonlocal total
        n = 1
        for d in shard_shape(tuple(leaf.shape), spec, mesh):
            n *= d
        total += n * leaf.element_size()
        return spec

    tree_map(add, tree, specs)
    return total


@dataclass(frozen=True, eq=False)
class Placement:
    """Where one tensor's shard lies: ``spec`` on ``mesh`` cuts the tensor
    of shape ``full``; this rank holds the block at its mesh coordinate.
    :func:`place` tags each tensor it cuts with one (:func:`placement`
    reads it back), and the model blocks read it to insert their
    collectives (``models/common.py``); a model itself keeps no rank."""

    mesh: Any
    spec: PartitionSpec
    full: tuple

    def axes_of(self, dim: int) -> tuple:
        e = self.spec[dim] if dim < len(self.spec) else None
        return () if e is None else e if isinstance(e, tuple) else (e,)

    def dim_of(self, axis: str):
        """The tensor dim split over mesh axis ``axis``, or None."""
        return next((i for i in range(len(self.full)) if axis in self.axes_of(i)), None)

    def split_axes(self) -> tuple:
        """The mesh axes the tensor is split over (sizes > 1), in mesh order."""
        sizes = axis_sizes(self.mesh)
        return tuple(a for a in axis_names(self.mesh)
                     if sizes[a] > 1 and self.dim_of(a) is not None)

    @property
    def shape(self) -> tuple:
        return shard_shape(self.full, self.spec, self.mesh)

    def offset(self, dim: int) -> int:
        """The index along ``dim`` where this rank's block starts (axes of
        a tuple entry major to minor, as JAX orders them)."""
        sizes = axis_sizes(self.mesh)
        idx = 0
        for a in self.axes_of(dim):
            idx = idx * sizes[a] + int(self.mesh.get_local_rank(a))
        return idx * self.shape[dim]

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full`` (a view)."""
        if tuple(full.shape) != tuple(self.full):
            raise ValueError(f"a tensor of {tuple(full.shape)} for a placement of "
                             f"{self.full}")
        for dim, n in enumerate(self.shape):
            if n != full.shape[dim]:
                full = full.narrow(dim, self.offset(dim), n)
        return full


_TAG = "_repro_placement"


def placement(t) -> "Placement | None":
    """The :class:`Placement` a tensor was cut by (None for a whole
    tensor)."""
    return getattr(t, _TAG, None)


def tag(t: torch.Tensor, pl: "Placement | None") -> torch.Tensor:
    """``t`` (this rank's block) marked as cut by ``pl``; returns ``t``."""
    if pl is not None:
        if tuple(t.shape) != pl.shape:
            raise ValueError(f"a block of {tuple(t.shape)} for a placement of {pl.full} "
                             f"under {pl.spec}: its blocks are {pl.shape}")
        setattr(t, _TAG, pl)
    return t


def place(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors where ``specs`` put them on ``mesh``.

    On a mesh of one device every shard is the whole tensor, so each goes
    to that device (no copy when it is there already).  On a mesh of more
    than one rank each leaf becomes this rank's block on its device, tagged
    with its :class:`Placement`: a whole tensor is cut; a ``meta`` one is
    allocated at the block's shape (filled later: a model's ``init``, a
    checkpoint); one already tagged with the same spec is kept.  A
    parameter keeps its identity (its ``.data`` is replaced), so a model
    holds its blocks."""
    from repro_torch.launch.mesh import is_sharded

    dev = mesh_device(mesh, "placing tensors by the plan")

    def one(leaf, spec):
        if len(spec) > leaf.dim():
            raise ValueError(f"spec {spec} for a tensor of {tuple(leaf.shape)}")
        if not is_sharded(mesh):
            return leaf if leaf.device == dev else leaf.to(dev)
        old = placement(leaf)
        if old is not None:
            if old.mesh is not mesh or old.spec != spec:
                raise ValueError(f"a block placed by {old.spec} cannot be re-placed by "
                                 f"{spec}: gather it first")
            return leaf
        pl = Placement(mesh, spec, tuple(leaf.shape))
        if leaf.device.type == "meta":
            block = torch.empty(pl.shape, dtype=leaf.dtype, device=dev)
        else:
            block = pl.cut(leaf).to(dev, copy=True).contiguous()
        if isinstance(leaf, torch.nn.Parameter):
            # the same Python object, now this block (a ``meta`` parameter
            # cannot take a CPU or CUDA tensor through ``.data``)
            torch.utils.swap_tensors(leaf, torch.nn.Parameter(block, leaf.requires_grad))
            return tag(leaf, pl)
        return tag(block, pl)

    return tree_map(one, tree, specs)


def gather(tree: Any) -> Any:
    """Whole tensors from ``tree``'s blocks (untagged leaves pass through):
    every leaf all-gathered over each mesh axis it is split over, minor
    axes first.  Every rank of the mesh must call it, on the same tree:
    for checkpoints and tests."""
    from repro_torch.core import collectives

    def one(leaf):
        pl = placement(leaf)
        if pl is None:
            return leaf
        out = leaf.detach()
        for dim in range(len(pl.full)):
            for a in reversed(pl.axes_of(dim)):
                out = collectives.all_gather_rows(out.movedim(dim, 0), pl.mesh, a)\
                    .movedim(0, dim)
        return out.contiguous()

    return tree_map(one, tree)


@torch.no_grad()
def assign(dst: dict, src: dict) -> None:
    """Copy ``src``'s tensors into ``dst``'s (same names): a block of
    ``src`` as it is, a whole tensor cut to the block ``dst`` holds
    (:class:`Placement`), on ``dst``'s device and dtype."""
    if dst.keys() != src.keys():
        raise KeyError(f"names differ: {sorted(set(dst) ^ set(src))}")
    for name, d in dst.items():
        s, pl, held = src[name], placement(d), placement(src[name])
        if held is not None and (pl is None or held.mesh is not pl.mesh
                                 or held.spec != pl.spec):
            raise ValueError(f"{name}: a block placed by {held.spec} on another mesh or "
                             "plan; gather it first")
        d.copy_(s if pl is None or held is not None else pl.cut(s))


def row_block(mesh, b: int) -> tuple[int, int, Any]:
    """``(start, stop, axes)``: this rank's rows of a ``b``-row batch under
    ``plan_batch``'s rule (rows over the data axes where they divide
    ``b``), and the data axes they are split over (None: every rank holds
    every row)."""
    from repro_torch.launch.mesh import is_sharded

    if not is_sharded(mesh):
        return 0, b, None
    ax = axes_for(mesh)
    sizes = axis_sizes(mesh)
    n = 1
    for a in ax.dp:
        n *= sizes[a]
    if n == 1 or b % n:
        return 0, b, None
    idx = 0
    for a in ax.dp:
        idx = idx * sizes[a] + int(mesh.get_local_rank(a))
    per = b // n
    return idx * per, (idx + 1) * per, ax.dp
