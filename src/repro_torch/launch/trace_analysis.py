"""Static analysis of one step as PyTorch runs it: the counterpart of
``repro/launch/hlo_analysis.py``.

There is no HLO in the port: a step is eager PyTorch plus the registry's
hand-written kernels, which bypass the ATen dispatcher.  :func:`analyze`
runs the step once under a ``TorchDispatchMode`` that sees every ATen op,
with the kernels' entry functions wrapped for the same call, and derives
JAX's ``HloStats`` fields, per device:

  * ``flops``: the registry's kernel ops from their shapes (a product
    ``2 m n k``, a slab of a batched product each; attention forward ``4 b h
    sq sk hd`` and backward ``10 b h sq sk hd``, masked pairs included, as
    XLA's dot count over the same shapes), plus every other ATen op that
    ``torch.utils.flop_counter`` counts (``mm``, ``bmm``, convolutions,
    SDPA).  ATen ops inside a kernel op (its plain version on a CPU tensor)
    are not counted again, so a step counts the same on the CPU, the card
    and ``meta``;
  * ``hbm_bytes``: operand bytes plus result bytes of every materializing
    op (every kernel op, every ATen op that is not a view);
  * ``collective_bytes``: per-collective wire bytes per device of the c10d
    collectives, by JAX's ring cost models (all-reduce 2S(N-1)/N,
    all-gather S(N-1)/N, reduce-scatter S_in(N-1)/N, all-to-all S(N-1)/N,
    send / recv S); on one device there are none;
  * ``collectives``: the per-collective breakdown.

A step with the layers' per-layer checkpoint counts its recomputed
forward, as XLA's rematerialized HLO does.  :func:`profile_device` reads a
``torch.profiler`` trace of the same step on the card for its device time
per op.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# c10d op names (functional and in-place forms) -> JAX's collective kinds
_C10D = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "all_reduce_coalesced":
    "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


@dataclass
class HloStats:
    """JAX's ``HloStats`` fields (``n_while`` and ``unknown_trip_counts``
    stay 0: an eager step has no loops to weigh), plus the port's split of
    ``flops`` between the kernel ops and ATen, and per-op counts."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    n_while: int = 0
    unknown_trip_counts: int = 0
    kernel_flops: float = 0.0
    aten_flops: float = 0.0
    ops: dict = field(default_factory=dict)  # op -> {"count", "flops", "bytes"}
    peak_alloc_bytes: float = 0.0  # the most bytes the step's own allocations held at once

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "n_while": self.n_while,
            "unknown_trip_counts": self.unknown_trip_counts,
        }


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# the kernel ops' FLOPs from their operands' shapes
def _matmul_flops(a, b, *args, **kw) -> float:
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _attn_flops(q, k, *args, **kw) -> float:
    b, sq, h, hd = q.shape
    return 4.0 * b * h * sq * k.shape[1] * hd


def _attn_bwd_flops(q, k, *args, **kw) -> float:
    b, sq, h, hd = q.shape
    return 10.0 * b * h * sq * k.shape[1] * hd


def _kernel_entries():
    """(module, attribute, op name, flops) of each kernel entry the models'
    registry ops reach: K2 (batched too), K4, the attention forward (K1,
    and K1q within it) and its backward (K3)."""
    from importlib import import_module

    hbp_matmul, strassen_matmul, flash_attention = (
        import_module(f"repro_torch.kernels.{m}")
        for m in ("hbp_matmul", "strassen_matmul", "flash_attention"))
    return [
        (hbp_matmul, "hbp_matmul", "matmul", _matmul_flops),
        (strassen_matmul, "strassen_matmul", "matmul", _matmul_flops),
        (flash_attention, "flash_attention", "attention", _attn_flops),
        (flash_attention, "flash_attention_bwd", "attention_bwd", _attn_bwd_flops),
    ]


def _group_size(args, kwargs) -> int:
    """The size of a collective's process group, read from its group-name
    argument (1 when it cannot be read)."""
    import torch.distributed as dist

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return _resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 -- not a group name
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return 1


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Allocations:
    """The bytes of the storages a step allocates, live at once: a new
    storage (an op's output whose storage is none of its inputs') counts
    from its first tensor until the last tensor on it (views included) is
    gone; storages that existed before the step are not counted."""

    def __init__(self):
        self.refs: dict[int, list] = {}  # storage key -> [tensors alive, bytes]
        self.live = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        ref = self.refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self.refs[key]

    def observe(self, inputs, outputs) -> None:
        seen = {_storage_key(t) for t in inputs}
        for t in outputs:
            key = _storage_key(t)
            ref = self.refs.get(key)
            if ref is None:
                if key in seen:
                    continue  # a view of, or a write into, storage from before the step
                nbytes = t.untyped_storage().nbytes()
                ref = self.refs[key] = [0, nbytes]
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            ref[0] += 1
            weakref.finalize(t, self._release, key)


class _KernelEntry:
    """A kernel entry function counted by an analysis: calls go through the
    analyzer; attributes (a wrapper's ``launches`` counter, which the
    kernel's own code increments through its module global) read and write
    the function's own."""

    def __init__(self, analyzer, name: str, flops_of: Callable, fn: Callable):
        object.__setattr__(self, "_entry", (analyzer, name, flops_of, fn))

    def __call__(self, *args, **kwargs):
        analyzer, name, flops_of, fn = self._entry
        return analyzer.count_kernel(name, flops_of, fn, args, kwargs)

    def __getattr__(self, attr):
        return getattr(self._entry[3], attr)

    def __setattr__(self, attr, value):
        setattr(self._entry[3], attr, value)


class _Analyzer(TorchDispatchMode):
    def __init__(self, stats: HloStats, allocations: bool = False):
        super().__init__()
        self.stats = stats
        self.depth = 0  # > 0 inside a kernel op: its ATen ops are its own
        self.coll = defaultdict(lambda: {"count": 0.0, "wire_bytes": 0.0,
                                         "payload_bytes": 0.0})
        self.alloc = _Allocations() if allocations else None

    def _op(self, name: str, flops: float, nbytes: float) -> None:
        row = self.stats.ops.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def kernel(self, name: str, flops_of: Callable, fn: Callable) -> "_KernelEntry":
        return _KernelEntry(self, name, flops_of, fn)

    def count_kernel(self, name: str, flops_of: Callable, fn: Callable, args, kwargs):
        if self.depth:
            return fn(*args, **kwargs)
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        flops = flops_of(*args, **kwargs)
        nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        self.stats.kernel_flops += flops
        self.stats.flops += flops
        self.stats.hbm_bytes += nbytes
        self._op(name, flops, nbytes)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.alloc is not None:
            self.alloc.observe(
                [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)],
                [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
        if self.depth:
            return out
        packet = func.overloadpacket
        name = func.name()
        ns, _, short = name.partition("::")
        kind = _C10D.get(short.split(".")[0]) if ns in ("_c10d_functional", "c10d") else None
        if kind is not None:
            payload = float(_tensor_bytes(out) or _tensor_bytes(args))
            n = _group_size(args, kwargs)
            frac = (n - 1) / n if n > 1 else 0.0
            wire = {"all-reduce": 2.0 * payload * frac, "all-gather": payload * frac,
                    "reduce-scatter": payload * max(n - 1, 0),
                    "all-to-all": payload * frac}.get(kind, payload)
            self.stats.collective_bytes += wire
            acc = self.coll[kind]
            acc["count"] += 1
            acc["wire_bytes"] += wire
            acc["payload_bytes"] += payload
            return out
        if func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry

        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.stats.aten_flops += flops
            self.stats.flops += flops
        nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        self.stats.hbm_bytes += nbytes
        self._op(str(packet), flops, nbytes)
        return out


@contextlib.contextmanager
def counting(stats: Optional[HloStats] = None, *, allocations: bool = False):
    """Count every op run inside the block into ``stats`` (yielded); with
    ``allocations``, also the peak of the bytes the block's own allocations
    hold at once (``stats.peak_alloc_bytes``)."""
    stats = HloStats() if stats is None else stats
    mode = _Analyzer(stats, allocations)
    patched = []
    try:
        for module, attr, name, flops_of in _kernel_entries():
            fn = getattr(module, attr)
            patched.append((module, attr, fn))
            setattr(module, attr, mode.kernel(name, flops_of, fn))
        with mode:
            yield stats
    finally:
        for module, attr, fn in reversed(patched):
            setattr(module, attr, fn)
        stats.collectives = {k: v for k, v in sorted(mode.coll.items())}
        if mode.alloc is not None:
            stats.peak_alloc_bytes = float(mode.alloc.peak)


def analyze(fn: Callable, *args, allocations: bool = False, **kwargs) -> HloStats:
    """Run ``fn(*args, **kwargs)`` once (one step, on any device, ``meta``
    included) and count it: see the module docstring.  ``allocations``:
    also track the step's peak of live allocated bytes (the dry run's temp
    bytes, traced on ``meta``)."""
    with counting(allocations=allocations) as stats:
        fn(*args, **kwargs)
    return stats


def profile_device(fn: Callable, *args, top: int = 8, **kwargs) -> dict:
    """Device time of one call of ``fn`` on the card from a
    ``torch.profiler`` trace (CUPTI, which sees the hand-written kernels'
    launches too): ``{"device_ms", "n", "ops": {name: ms}}``, summed over
    the trace's device operations, the ``top`` names by device time.  The
    call runs once under the profiler, after the caller's own warm-up."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args, **kwargs)
        torch.cuda.synchronize()
    by_name: dict = defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
            n += 1
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    return {"device_ms": sum(by_name.values()), "n": n, "ops": dict(rows[:top])}


def roofline(stats: HloStats, peak_flops: float, hbm_bytes_per_s: float,
             link_bytes_per_s: float) -> dict:
    """JAX's roofline terms: each quantity per device over the device's
    peak, and the dominant one."""
    terms = {"compute_s": stats.flops / peak_flops,
             "memory_s": stats.hbm_bytes / hbm_bytes_per_s,
             "collective_s": stats.collective_bytes / link_bytes_per_s}
    terms["dominant"] = max(terms, key=terms.get)
    return terms
