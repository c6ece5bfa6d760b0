"""Ambient execution policy: the port's copy of ``repro/kernels/policy.py``.

Model code never names a backend; it asks ``registry.resolve`` /
``registry.dispatch``, which read the ambient :class:`ExecutionPolicy`, a
frozen value holding

  * ``impl``         — per-op backend map (``{"attention": "pallas", "*":
    "auto"}``); the ``"*"`` wildcard covers every op without its own entry,
    and the implicit default is ``"auto"``;
  * ``variants``     — per-op variant-knob overrides merged into dispatch
    under explicit call-site kwargs (``{"matmul": {"backend":
    "classical"}}``, ``{"attention": {"kv_dtype": "int8"}}``), and read by
    the model layer for ``{"matmul": {"qkv_fused": True}}`` (one QKV
    product per attention block, ``models.common.qkv_project``);
  * ``autotune``     — the measured-plan mode (``kernels/autotune.py``):
    ``"off"`` runs the planner's plans, ``"replay"`` overlays a tuned
    table's, ``"search"`` also measures a call the table misses; ``None``
    defers to the process mode (``autotune.mode()``);
  * ``interpret``    — the JAX knob that forces Pallas interpret mode.  The
    port has no interpret mode: ``True`` on a CUDA tensor raises
    ``ValueError``, and on a CPU tensor the plain version runs anyway;
  * ``strict_tiles`` — raise instead of warning when tile overrides are
    dropped on the oracle path;
  * ``reason``       — free-text provenance of a scoped override (``pin``).

Policies layer on a context stack, as in the JAX package:

    base:   ambient()      — assembled from REPRO_IMPL, REPRO_STRICT_TILES,
                             REPRO_INTERPRET
    pinned: install()      — the launcher-resolved process policy (``--impl``)
    scoped: apply()/pin()  — ``with``-blocks deriving from ``current()``

Op names are the registry's (``registry.names()``).  Backends name the
route of a call: ``auto`` and ``pallas`` mean the op's kernel wrapper (the
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor); ``jnp``
and ``ref`` mean the oracle, which the registry runs only on CPU tensors
(``registry.route``).

:func:`from_run_options` and :func:`bind` carry ``RunOptions``'
``attention_impl`` / ``matmul_impl`` / ``fused_qkv`` / ``autotune`` into a
policy scope around a model's entry points, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import os
from contextvars import ContextVar
from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Callable, Mapping, Optional

IMPLS = ("auto", "jnp", "ref", "pallas")
AUTOTUNE_MODES = ("off", "replay", "search")


def _frozen_map(d: Optional[Mapping]) -> Mapping:
    return MappingProxyType(dict(d or {}))


def _known_ops() -> set:
    from repro_torch.kernels import registry  # the registry imports this module

    return set(registry.names()) | {"*"}


@dataclass(frozen=True)
class ExecutionPolicy:
    """Every dispatch-time decision the port reads, as one immutable value.
    Build variations with :meth:`with_` and activate them with :func:`apply`
    / :func:`install`."""

    impl: Mapping[str, str] = field(default_factory=dict)
    variants: Mapping[str, Mapping] = field(default_factory=dict)
    autotune: Optional[str] = None
    interpret: Optional[bool] = None
    strict_tiles: bool = False
    reason: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "impl", _frozen_map(self.impl))
        object.__setattr__(
            self, "variants",
            _frozen_map({k: _frozen_map(v) for k, v in dict(self.variants).items()}))
        known = _known_ops()
        for op, backend in self.impl.items():
            if op not in known:
                raise ValueError(f"unknown op {op!r} in impl map; "
                                 f"registered: {sorted(known)}")
            if backend not in IMPLS:
                raise ValueError(
                    f"unknown impl {backend!r} for op {op!r}; expected one of {IMPLS}")
        for op in self.variants:
            if op not in known:
                raise ValueError(f"unknown op {op!r} in variants map; "
                                 f"registered: {sorted(known)}")
        if self.autotune is not None and self.autotune not in AUTOTUNE_MODES:
            raise ValueError(f"unknown autotune mode {self.autotune!r}; "
                             f"expected one of {AUTOTUNE_MODES}")

    def impl_for(self, op: str) -> str:
        """The op's backend: its own entry, else ``"*"``, else ``"auto"``."""
        return self.impl.get(op, self.impl.get("*", "auto"))

    def variant_for(self, op: str) -> dict:
        """The op's variant-knob overrides (a fresh plain dict)."""
        return dict(self.variants.get(op, {}))

    def with_(self, *, impl: Optional[Mapping] = None,
              variants: Optional[Mapping] = None, **updates) -> "ExecutionPolicy":
        """Functional update: ``impl`` and ``variants`` entries MERGE over
        the existing maps (an impl entry set to None deletes); scalar fields
        replace."""
        if impl is not None:
            merged = {**self.impl, **dict(impl)}
            updates["impl"] = {k: v for k, v in merged.items() if v is not None}
        if variants is not None:
            mv = dict(self.variants)
            for op, knobs in dict(variants).items():
                mv[op] = {**dict(mv.get(op, {})), **dict(knobs)}
            updates["variants"] = mv
        return replace(self, **updates)

    def describe(self) -> str:
        """One-line rendering whose impl/variant prefix round-trips through
        :func:`parse_impl_spec` (``op=backend:knob=value``; an op with
        variants but no impl entry prints as ``op=auto:...``)."""
        def _fmt_knob(v):
            return str(v).lower() if isinstance(v, bool) else str(v)

        parts = []
        for op in sorted(set(self.impl) | set(self.variants)):
            entry = f"{op}={self.impl.get(op, 'auto')}"
            for knob, v in sorted(self.variants.get(op, {}).items()):
                entry += f":{knob}={_fmt_knob(v)}"
            parts.append(entry)
        for f_name in ("autotune", "interpret", "strict_tiles", "reason"):
            v = getattr(self, f_name)
            if v not in (None, False):
                parts.append(f"{f_name}={v}")
        return ",".join(parts) or "auto"


def _parse_knob_value(raw: str):
    """Typed variant-knob values: bools (``true``/``false``), ints, else the
    raw string (e.g. a dtype name or a matmul backend)."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        return raw


def parse_impl_spec(spec: str) -> tuple[dict[str, str], dict[str, dict]]:
    """The ``--impl`` / ``REPRO_IMPL`` grammar with variant knobs:
    ``op=backend[:knob=value]*[,op=backend...]`` — e.g.
    ``matmul=pallas:backend=classical`` or ``attention=pallas:kv_dtype=int8``.
    Returns ``(impl, variants)`` maps ready for :meth:`ExecutionPolicy.with_`.
    A bare backend with no ``=`` is shorthand for the wildcard (``pallas`` ==
    ``*=pallas``); knobs on the wildcard are rejected.  Unknown op names
    raise: a typo'd entry would otherwise match nothing and leave every op on
    ``auto``."""
    known = _known_ops()
    impl: dict[str, str] = {}
    variants: dict[str, dict] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        head, *knob_parts = part.split(":")
        if "=" in head:
            op, _, backend = head.partition("=")
            op, backend = op.strip(), backend.strip()
        else:
            op, backend = "*", head
        if not op:
            raise ValueError(f"bad --impl entry {part!r}: empty op name")
        if op not in known:
            raise ValueError(f"bad --impl entry {part!r}: unknown op {op!r} "
                             f"(registered: {sorted(known)})")
        if backend not in IMPLS:
            raise ValueError(f"bad --impl entry {part!r}: unknown backend "
                             f"{backend!r} (expected one of {IMPLS})")
        impl[op] = backend
        for kp in knob_parts:
            kp = kp.strip()
            if not kp:
                continue
            if op == "*":
                raise ValueError(f"bad --impl entry {part!r}: variant knobs "
                                 "need a concrete op, not the * wildcard")
            knob, sep, val = kp.partition("=")
            if not sep or not knob.strip() or not val.strip():
                raise ValueError(f"bad --impl entry {part!r}: variant knob "
                                 f"{kp!r} must be knob=value")
            variants.setdefault(op, {})[knob.strip()] = \
                _parse_knob_value(val.strip())
    return impl, variants


def _truthy(val: Optional[str]) -> bool:
    return bool(val) and val.lower() not in ("0", "false", "no", "")


# the assembled ambient, keyed on the env values it was read from
_AMBIENT_CACHE: dict[tuple, ExecutionPolicy] = {}


def ambient() -> ExecutionPolicy:
    """The base of the policy stack, from ``REPRO_IMPL`` (the ``--impl``
    grammar), ``REPRO_STRICT_TILES`` and ``REPRO_INTERPRET``.  Memoized per
    env value."""
    env = os.environ
    key = (env.get("REPRO_IMPL"), env.get("REPRO_STRICT_TILES"), env.get("REPRO_INTERPRET"))
    hit = _AMBIENT_CACHE.get(key)
    if hit is not None:
        return hit
    impl_env, strict_env, interp_env = key
    impl, variants = parse_impl_spec(impl_env) if impl_env else ({}, {})
    pol = ExecutionPolicy(impl=impl, variants=variants,
                          strict_tiles=_truthy(strict_env),
                          interpret=True if _truthy(interp_env) else None)
    _AMBIENT_CACHE.clear()
    _AMBIENT_CACHE[key] = pol
    return pol


_STACK: ContextVar[tuple] = ContextVar("repro_torch_policy_stack", default=())
_PROCESS: Optional[ExecutionPolicy] = None


def current() -> ExecutionPolicy:
    """The active policy: innermost ``apply`` scope, else the installed
    process policy, else the environment-assembled ambient."""
    stack = _STACK.get()
    if stack:
        return stack[-1]
    if _PROCESS is not None:
        return _PROCESS
    return ambient()


def install(pol: Optional[ExecutionPolicy]) -> None:
    """Pin (or with None clear) the process-level policy: the launcher hook
    behind ``--impl``.  Scoped ``apply`` blocks still layer on top."""
    global _PROCESS
    _PROCESS = pol


@contextlib.contextmanager
def apply(pol: Optional[ExecutionPolicy] = None, **updates):
    """Push a policy scope: exactly ``pol``, or :func:`current` updated by
    :meth:`ExecutionPolicy.with_`.  Restores the previous stack on exit."""
    new = pol if pol is not None else current()
    if updates:
        new = new.with_(**updates)
    token = _STACK.set(_STACK.get() + (new,))
    try:
        yield new
    finally:
        _STACK.reset(token)


def pin(op: str, backend: str, *, reason: str):
    """Scoped single-op override with recorded provenance.  ``reason`` is
    mandatory: a pin without a why is a hardcoded string with extra steps."""
    return apply(impl={op: backend}, reason=reason)


def pin_if(cond, op: str, backend: str, *, reason: str):
    """:func:`pin` when ``cond`` (a Python bool), else a no-op scope."""
    return pin(op, backend, reason=reason) if cond else contextlib.nullcontext()


def from_run_options(opts) -> Optional[dict]:
    """Translate ``RunOptions``' backend knobs (``attention_impl`` /
    ``matmul_impl`` / ``fused_qkv`` / ``autotune``) into :func:`apply`
    updates, or None when every field is at its ambient-deferring default.
    The same update dict as JAX's ``from_run_options`` for the same
    options."""
    updates: dict = {}
    impl = {}
    for op, fld in (("attention", "attention_impl"), ("matmul", "matmul_impl")):
        v = getattr(opts, fld, "auto")
        if v != "auto":
            impl[op] = v
    if impl:
        updates["impl"] = impl
    if getattr(opts, "fused_qkv", False):
        # one (d, q+k+v) product per attention block instead of three: the
        # model layer reads this variant in ``common.qkv_project``
        updates["variants"] = {"matmul": {"qkv_fused": True}}
    tune = getattr(opts, "autotune", None)
    if tune is not None:
        updates["autotune"] = tune
    return updates or None


def bind(updates: Optional[dict], fn: Callable) -> Callable:
    """Wrap ``fn`` so each call runs under ``apply(**updates)``.  No-op for
    None.  The updated policy is derived once per base policy (the last
    one is kept), so repeated calls reuse one policy object and the
    registry's memoized routes for it."""
    if not updates:
        return fn
    last = [(None, None)]  # (base policy, its update), swapped as one value

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        base = current()
        seen, derived = last[0]
        if seen is not base:
            derived = base.with_(**updates)
            last[0] = (base, derived)
        with apply(derived):
            return fn(*args, **kwargs)

    return wrapper
