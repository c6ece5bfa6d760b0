"""Kernel registry: one policy-driven dispatch path for every op, the port's
copy of ``repro/kernels/registry.py``.

Each op registers a :class:`KernelSpec`: the kernel's wrapper, the plain
oracle (``ref.py``), a planner hook deriving the tile kwargs from the
device's parameters (``planner.py``), and capability metadata (``has_vjp``,
the ``needs`` gate).  Registered ops: ``scan`` (K5), ``matmul`` (K2, or
K4 for a square product past the cutoff), ``transpose`` (K6), ``attention``
(K1, K1q, K3) and ``fft`` (K7).

Where JAX asks ``supported()`` of the process (``default_backend() ==
"tpu"``), the port asks the tensor: a process with a card also runs CPU
tensors.  :func:`route` is that rule, a function of (policy choice, device
type, spec):

* ``auto`` and ``pallas`` take the kernel's wrapper, which launches the
  CUDA kernel on a CUDA tensor, runs its plain version on a CPU tensor and
  gives a ``meta`` tensor the kernel's output shapes alone (the dry run's
  trace, ``launch/dryrun.py``), through the same autograd Functions;
* ``jnp`` and ``ref`` take the oracle on a CPU tensor and raise
  ``NotImplementedError`` on a CUDA tensor: the port runs no plain version
  on the card;
* where JAX falls back to the oracle quietly (an op without a backward
  under a caller that may differentiate, or a call its ``needs`` gate
  refuses), the port does so on a CPU tensor and raises
  ``NotImplementedError`` on a CUDA tensor, naming the op and the reason.

The plain versions stay reachable on the card only by importing them.

:func:`resolve` answers which backend a call would take (``differentiable``
callers; the models need not ask, since both of their ops carry a
backward); :func:`dispatch` runs the resolved backend: the oracle for
``jnp``/``ref``, else the wrapper with the planner's tiles, under the
policy's variant overrides, under explicit call-site tile kwargs.  Only
an op's own knobs (``KernelSpec.pallas_only``) reach its wrapper; the
matmul op's ``qkv_fused`` variant is read by the model layer
(``models.common.qkv_project``), which then dispatches one product.  The
route is memoized on (op, policy, impl, device type, ``needs`` verdict) and
the plan on (op, shapes, dtypes, device, ``REPRO_FAST_BYTES``), and
dispatch makes no host sync, so it runs under CUDA-graph capture.

Between the planner's plan and the policy's variants sits the measured
autotune (``autotune.py``), as in JAX: under ``replay`` or ``search`` a
tuned table entry for the call overlays the plan (K2's ``tile_n`` and
``splits``, the matmul ``backend`` and ``cutoff``, K1q's ``splits``, K5's
``block``, K6's ``bt`` and ``morton``, K7's ``n1``), then the policy's
variants, then explicit kwargs; forced variant knobs key the lookup.  The
overlay is memoized in the plan's entry, whose key then adds the mode, the
table generation, strides, 16-byte alignment, the semantic kwargs and the
forced variants, so a repeated call pays one key and two dict lookups, no
table I/O and no host sync.

The same op names key the simulator side: :func:`simulator_program` builds
the op's access-trace HBP program from ``repro_torch.core.algorithms``
(``scan``, ``matmul``, ``transpose``, ``fft``), so kernel dispatch and the
simulator's cost cross-checks share one namespace.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import autotune, planner, policy
from repro_torch.kernels.bi_fft import bi_fft, fft_ref
from repro_torch.kernels.bi_transpose import bi_transpose, transpose_ref
from repro_torch.kernels.bp_scan import bp_scan, bp_scan_ref
from repro_torch.kernels.flash_attention import attention, attention_ref
from repro_torch.kernels.hbp_matmul import matmul_ref
from repro_torch.kernels.strassen_matmul import matmul as backend_matmul

# the device types a kernel wrapper serves: CUDA by its kernel, CPU by its
# plain version, ``meta`` by the kernel's output shapes alone (the dry run's
# trace counts what the kernel allocates, not the plain version's
# intermediates)
WRAPPER_DEVICES = ("cuda", "cpu", "meta")
PLAIN_IMPLS = ("jnp", "ref")


@dataclass(frozen=True)
class KernelSpec:
    """One registered op.

    ``kernel`` is the wrapper; ``plan(*tensors) -> dict`` gives its tile
    kwargs; ``pallas_only`` names the kwargs (tiles and schedule knobs,
    JAX's tuple) stripped before calling the oracle, which takes semantic
    kwargs only.  ``has_vjp`` marks ops whose kernel carries a backward;
    ``needs(**context) -> bool`` is the capability gate over the call's
    semantic kwargs.  A ``pallas_only`` kwarg that the port's kernel fixes
    itself (K2's ``bm``/``bn``/``bk``/``morton``, K1's blocks) is not a
    parameter of the wrapper and raises ``TypeError`` on the kernel path;
    the knobs the wrappers take (K2's ``tile_n``/``splits``, K1q's
    ``splits``) are what the autotune overlays.  ``simulator(n, mem, **kw)``
    builds the op's access-trace twin from ``repro_torch.core.algorithms``
    (None: no simulator program for this op, as for ``attention``)."""

    name: str
    kernel: Callable
    ref: Callable
    plan: Callable
    pallas_only: Tuple[str, ...] = ()
    has_vjp: bool = False
    needs: Optional[Callable[..., bool]] = None
    simulator: Optional[Callable] = None


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: {names()}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def route(spec: KernelSpec, choice: str, device_type: str, *,
          differentiable: bool = False, fits: bool = True) -> str:
    """The backend that serves a call: ``"pallas"`` (the kernel's wrapper)
    or ``"jnp"`` (the oracle), from the policy's ``choice``, the device type
    of the call's tensors and the spec.  ``differentiable``: the caller may
    differentiate; ``fits``: the ``needs`` gate took the call.  Raises
    ``NotImplementedError`` wherever the answer would be the oracle on a
    CUDA tensor (see the module docstring)."""
    if choice == "auto":
        choice = "pallas" if device_type in WRAPPER_DEVICES else "jnp"
    if choice in PLAIN_IMPLS:
        if device_type == "cuda":
            raise NotImplementedError(
                f"{spec.name}={choice} asks for the plain version on a CUDA tensor; "
                "the port runs its kernel there (auto or pallas) and the plain "
                "versions only on CPU tensors")
        return "jnp"
    if choice != "pallas":
        raise ValueError(f"unknown impl {choice!r} for op {spec.name!r}; "
                         f"expected one of {policy.IMPLS}")
    reason = None
    if differentiable and not spec.has_vjp:
        reason = "its kernel has no backward and the caller may differentiate"
    elif not fits:
        reason = "its kernel cannot take this call (the needs gate refused the call's kwargs)"
    if reason is None:
        return "pallas"
    if device_type == "cuda":
        raise NotImplementedError(
            f"{spec.name}: {reason}; JAX runs the oracle here, and the port runs "
            "no plain version on a CUDA tensor")
    return "jnp"


def resolve(name: str, pol: Optional[policy.ExecutionPolicy] = None, *, device,
            differentiable: bool = True, **context) -> str:
    """Resolve the op's backend for tensors on ``device`` under the
    (ambient) policy: ``"pallas"`` or ``"jnp"``, by :func:`route`, with
    ``needs`` applied to ``context``.  ``ref`` resolves like ``jnp``."""
    spec = get(name)
    if pol is None:
        pol = policy.current()
    fits = spec.needs is None or spec.needs(**context)
    device_type = device.type if isinstance(device, torch.device) else torch.device(device).type
    return route(spec, pol.impl_for(name), device_type,
                 differentiable=differentiable, fits=fits)


# ops already warned about dropped overrides (once per op);
# reset_warnings() clears it between tests
_WARNED_DROPPED: set[str] = set()


def reset_warnings() -> None:
    """Test hook: clear the registry's and the autotune's warn/log-once
    state."""
    _WARNED_DROPPED.clear()
    autotune._INTERP_LOGGED.clear()


def _check_dropped_overrides(name: str, overrides: dict, *, strict: bool) -> None:
    """The oracle takes semantic kwargs only, so tile overrides on the ref
    path never reach a kernel: warn once per op, or raise under
    ``REPRO_STRICT_TILES`` / a ``strict_tiles`` policy."""
    dropped = sorted(k for k, v in overrides.items() if v is not None)
    if not dropped:
        return
    msg = (f"dispatch({name!r}): tile override(s) {dropped} ignored on the "
           "ref path (the oracle takes semantic kwargs only); force "
           "impl='pallas' to exercise the tiles")
    if strict:
        raise ValueError(msg)
    if name not in _WARNED_DROPPED:
        _WARNED_DROPPED.add(name)
        warnings.warn(msg, stacklevel=3)


# (op, device, REPRO_FAST_BYTES, each tensor's shape and dtype) -> the
# planner's tile kwargs.  Under an autotune mode the key adds the mode, the
# tables' generation, each tensor's strides and 16-byte alignment (they pick
# the kernel instance whose knobs the overlay snaps to), the call's
# non-tensor kwargs and its forced variants, and the entry holds the tuned
# knobs merged over the plan.  A redirected REPRO_TUNE_DIR takes effect at
# autotune.clear_cache(), which bumps the generation.
_PLANS: dict = {}


def _plan(spec: KernelSpec, args, device, fast_bytes, mode: str, kwargs: dict,
          variant: Optional[dict]) -> dict:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if mode == "off":
        key = (spec.name, device, fast_bytes, *[(a.shape, a.dtype) for a in tensors])
    else:
        key = (spec.name, device, fast_bytes, mode, autotune.generation(),
               *[(a.shape, a.dtype, a.stride(), a.data_ptr() % 16 == 0) for a in tensors],
               *[(k, v) for k, v in kwargs.items() if not isinstance(v, torch.Tensor)],
               *sorted(variant.items()))
    plan = _PLANS.get(key)
    if plan is None:
        plan, final = dict(spec.plan(*args)), True
        if mode != "off":
            tuned, final = autotune._overlay(spec.name, args, {**kwargs, **variant})
            plan.update(tuned)
        if final:
            if len(_PLANS) >= 4096:
                _PLANS.clear()
            _PLANS[key] = plan
    return plan


# (op, id of the policy, per-call impl, device type, needs verdict) -> (the
# policy, the backend, the policy's tile knobs for the op, its interpret
# setting).  Policies are immutable, so an entry holds while its policy
# lives; the entry keeps the policy alive, so its id is not reused.
_RESOLVED: dict = {}


def _resolved(spec: KernelSpec, pol: policy.ExecutionPolicy, impl: Optional[str],
              device_type: str, fits: bool):
    key = (spec.name, id(pol), impl, device_type, fits)
    hit = _RESOLVED.get(key)
    if hit is not None:
        return hit
    choice = pol.impl_for(spec.name) if impl is None else impl
    backend = route(spec, choice, device_type, fits=fits)
    knobs = pol.variants.get(spec.name, {})
    tiles = {k: v for k, v in knobs.items() if k in spec.pallas_only}
    interpret = knobs.get("interpret")
    if interpret is None:
        interpret = pol.interpret
    if len(_RESOLVED) >= 1024:  # scoped policies come and go
        _RESOLVED.clear()
    hit = _RESOLVED[key] = (pol, backend, tiles, interpret)
    return hit


def dispatch(name: str, *args, impl: Optional[str] = None,
             interpret: Optional[bool] = None, **kwargs):
    """Generic dispatch under the ambient policy.  ``impl`` is the per-call
    override (``"auto"`` | ``"jnp"``/``"ref"`` | ``"pallas"``); None reads
    the policy.  An unforced choice honors the ``needs`` gate; an explicit
    ``impl="pallas"`` skips it.  ``interpret`` (else the op's ``interpret``
    knob, else the policy's) may not be true on a CUDA tensor.  The kernel
    path runs the planner's plan, overlaid by the autotune's tuned plan
    (``autotune.mode()`` not ``off``), the policy's variants and the
    explicit kwargs, strongest last.  The route is memoized per (op,
    policy, impl, device type, ``needs`` verdict) and the plan with its
    overlay per call signature (``_PLANS``), so a repeated call pays two
    lookups."""
    spec = get(name)
    device = args[0].device
    device_type = device.type
    fits = ((impl is not None and impl != "auto") or spec.needs is None
            or spec.needs(**kwargs))
    pol, backend, pol_tiles, pol_interpret = _resolved(
        spec, policy.current(), impl, device_type, fits)
    explicit = {}
    for k in spec.pallas_only:
        if k in kwargs:
            v = kwargs.pop(k)
            if v is not None:
                explicit[k] = v
    if backend == "jnp":
        _check_dropped_overrides(name, {**pol_tiles, **explicit},
                                 strict=pol.strict_tiles)
        return spec.ref(*args, **kwargs)
    if interpret is None:
        interpret = pol_interpret
    if interpret and device_type == "cuda":
        raise ValueError(f"dispatch({name!r}): interpret mode has no meaning on a "
                         "CUDA tensor; the port's kernels compile for the card")
    forced = {**pol_tiles, **explicit}
    mode = autotune.mode(pol)
    # forced variant knobs (e.g. the matmul backend) select which table entry
    # to replay; tile overrides stay out (they win regardless)
    variant = ({k: v for k, v in forced.items() if k in autotune.variant_keys(name)}
               if mode != "off" else None)
    tiles = _plan(spec, args, device, os.environ.get("REPRO_FAST_BYTES"), mode, kwargs,
                  variant)
    if forced:
        tiles = {**tiles, **forced}
    return spec.kernel(*args, **kwargs, **tiles)


def _dp(x):
    return planner.device_params(x.device)


# ---------------------------------------------------------------------------
# simulator namespace: one op namespace for kernels and the simulator
# ---------------------------------------------------------------------------

def simulator_program(name: str, n: int, mem=None, **kwargs):
    """Build the op's access-trace HBP program (``repro_torch.core.algorithms``)
    under the name the kernel dispatches as (JAX ``registry.py:224-245``).
    ``n`` is the op's natural size (matrix edge for matmul/transpose,
    length for scan/fft); a fresh ``core.hbp.Memory`` is allocated unless
    one is given.  Returns what the core builder returns (a program, or a
    program list for the two-pass scan)."""
    spec = get(name)
    if spec.simulator is None:
        raise KeyError(f"kernel {name!r} has no registered simulator program; "
                       f"ops with one: "
                       f"{[s for s in names() if get(s).simulator is not None]}")
    if mem is None:
        from repro_torch.core.hbp import Memory

        mem = Memory()
    return spec.simulator(n, mem, **kwargs)


def _sim_scan(n, mem, **kw):
    from repro_torch.core import algorithms

    return algorithms.prefix_sums_programs(n, mem, **kw)


def _sim_matmul(n, mem, **kw):
    from repro_torch.core import algorithms

    return algorithms.strassen_program(n, mem, **kw)


def _sim_transpose(n, mem, **kw):
    from repro_torch.core import algorithms

    return algorithms.MTBI(n, mem, **kw)


def _sim_fft(n, mem, **kw):
    from repro_torch.core import algorithms

    return algorithms.fft_program(n, mem, **kw)


# ---------------------------------------------------------------------------
# registrations
# ---------------------------------------------------------------------------

register(KernelSpec(
    name="scan",
    kernel=bp_scan,
    ref=bp_scan_ref,
    plan=lambda x: planner.plan_scan(x.shape, x.dtype, _dp(x)),
    pallas_only=("block",),
    simulator=_sim_scan,
))

def _plan_matmul(a, b) -> dict:
    """The backend verdict for a 2-D product; a batched (E, m, k) @ (E, k, n)
    one (the MoE experts' products, ``common.expert_project``) is one
    batched K2 launch, the classical backend: no expert product is square."""
    if a.dim() == 3:
        return {"backend": "classical"}
    return planner.plan_matmul_backend(a.shape[0], a.shape[1], b.shape[1], a.dtype, _dp(a))


register(KernelSpec(
    name="matmul",
    # classical -> one K2 call, strassen -> K4 (f32: fused launches; bf16:
    # the recursion over K2); carries
    # its backward (dA = g Bᵀ, dB = Aᵀ g, each re-planned).  K2 sizes its
    # own launch (hbp_matmul.plan), so the plan is the backend verdict; the
    # autotune may overlay K2's tile_n and splits (forward product only).
    # 3-D operands: E products in one batched K2 launch
    kernel=backend_matmul,
    ref=matmul_ref,
    plan=_plan_matmul,
    pallas_only=("bm", "bn", "bk", "morton", "backend", "cutoff", "tile_n", "splits"),
    has_vjp=True,
    simulator=_sim_matmul,
))

register(KernelSpec(
    name="transpose",
    kernel=bi_transpose,
    ref=transpose_ref,
    plan=lambda x: planner.plan_transpose(x.shape[0], x.shape[1], x.dtype, _dp(x)),
    pallas_only=("bt", "morton"),
    simulator=_sim_transpose,
))

register(KernelSpec(
    name="attention",
    kernel=attention,
    ref=attention_ref,
    # K1, K1q and K3 fix their own blocks; K1q plans its cluster split
    # (flash_attention.kv_splits), which the autotune may overlay
    plan=lambda q, k, v: {},
    pallas_only=("q_block", "kv_block", "splits"),
    has_vjp=True,
    # the kernel hard-codes the 1/sqrt(hd) scale and takes a static int window
    needs=lambda softmax_scale=None, window=None, **_: (
        softmax_scale is None and isinstance(window, (int, type(None)))),
))

register(KernelSpec(
    name="fft",
    kernel=bi_fft,
    ref=fft_ref,
    plan=lambda x: planner.plan_fft(x.shape[-1]),
    pallas_only=("n1",),
    simulator=_sim_fft,
))
