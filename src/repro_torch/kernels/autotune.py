"""Measured autotune layer over the planner: the port's copy of
``repro/kernels/autotune.py``, function for function.

The planner (``planner.py``) and each kernel's own plan (``hbp_matmul.plan``,
``flash_attention.kv_splits``) derive every launch analytically.  Their
models carry constant factors the card may disagree with; this module
measures each device's constants and replays them, without changing what
any kernel computes.

Three pieces, as in JAX:

``candidates(op, *tensors)``
    A power-of-two ladder of plans around the analytic one, filtered by
    what the call's kernel instance accepts (its templates, its cluster
    size, the shared memory it was built for: the validators of
    ``hbp_matmul.check_override`` and ``flash_attention.check_splits``,
    and each wrapper's divisibility rule), crossed with the op's variants.
    The analytic plan is always candidate 0, at most 16 in all.

``search(op, *tensors)``
    Times each candidate on the call's own tensors (:func:`measure_us`: one
    warm-up call, which also absorbs a kernel's first build, then the
    median of ``iters`` by CUDA events; the plain version's wall time on a
    CPU tensor) and records the winner in the device's table, unless it
    beats the analytic plan by no more than the analytic plan's own spread
    (JAX records any winner): a noise winner would change roundings for
    nothing.  A candidate that fails raises: the ladder holds only plans
    the validators accept.

``overlay(op, tensors)``
    The dispatch-time hook: a table hit for the call's key overlays the
    analytic plan (snapped back to what the call's instance takes), under
    the mode knob:

      * ``off``    — analytic plans only (the bare-dispatch default);
      * ``replay`` — overlay persisted measurements; a cold cache is a no-op;
      * ``search`` — like replay, but a table miss triggers an in-line search
        whose winner is persisted; never while a CUDA stream is being
        captured (``torch.cuda.is_current_stream_capturing()``, JAX's
        tracer test), where it replays.

    ``REPRO_AUTOTUNE`` sets the process default; launchers call
    :func:`startup` (which resolves ``RunOptions.autotune``) and tests use
    :func:`mode_scope`.  ``registry.dispatch`` memoizes the overlay per
    call signature, mode and table generation (:func:`generation`).

The knobs are the port's wrappers' own (``OpTuneInfo`` / ``_TUNE``):

  * ``matmul``: ``backend`` and ``cutoff`` (JAX's variants: K4 against K2),
    and the classical backend's K2 plan, ``tile_n`` and ``splits``;
  * ``attention``: ``splits``, K1q's cluster, where the kernel reads it
    (bf16 ``q`` over an int8 cache); every other attention call has no knob
    and its overlay is ``{}`` (K1 and K3 fix their blocks);
  * ``scan``: ``block``; ``transpose``: ``bt`` and ``morton``; ``fft``:
    ``n1``.

Tables are JSON files under ``REPRO_TUNE_DIR`` (default
``~/.cache/repro/autotune``), one per sanitized ``device_kind``
(``planner.device_params(device).kind``: ``NVIDIA H100 80GB HBM3`` on the
card, ``cpu`` on the CPU), named ``torch-<kind>.json`` so that they sit
beside JAX's ``<kind>.json`` in the same directory and neither package's
search overwrites the other's table, in JAX's format: ``version`` 3, ``device_kind``,
``entries`` of ``{plan, us, analytic_plan, analytic_us, iters,
candidates}``, keyed by JAX's strings for the same call (``entry_key``:
an attention call keys by the JAX kernel's folded ``(b * heads, s, hd)``
operands; a batched 3-D product, which JAX keys per slab under ``vmap``,
keys by its 3-D shapes).  Where JAX stamps ``jax_version``, the port stamps
``torch_version`` and ``kernels``, the digest of the kernel sources
(``_build.source_digest``): a table with any other stamp is cold, so tuned
timings do not survive a toolchain or kernel change, and a JAX-written
table is cold here (and a port-written one in JAX).  Corrupt or foreign
files are cold, never fatal.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import json
import logging
import math
import os
import re
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.kernels import planner

log = logging.getLogger("repro_torch.autotune")

MODES = ("off", "replay", "search")
_DEFAULT_DIR = "~/.cache/repro/autotune"
# JAX's table version (v3: matmul keys its derived backend flag, plans may
# carry variant knobs)
_TABLE_VERSION = 3

_mode_override: Optional[str] = None
# (tune_dir, device_kind) -> entries dict; cleared by clear_cache()
_TABLE_CACHE: dict[tuple[str, str], dict] = {}
# bumped whenever a table the overlay reads may have changed
_GENERATION = [0]

# per-op semantic kwargs folded into the table key, with the kernel
# defaults so omitted kwargs key identically to explicitly-passed defaults
_SEM_FLAGS: dict[str, dict] = {"attention": {"causal": True, "window": 0}}


def generation() -> int:
    """The tables' generation: bumped by :func:`clear_cache` and every
    entry :func:`search` records, so a memoized overlay keyed on it is
    never stale."""
    return _GENERATION[0]


# ---------------------------------------------------------------------------
# mode knob
# ---------------------------------------------------------------------------

def resolve_mode(value: Optional[str] = None) -> str:
    """Launcher-side resolution: explicit value > ``REPRO_AUTOTUNE`` >
    ``replay`` (replay on a cold cache is a no-op, so it is the safe
    startup default).  Raises on unknown modes so typos surface early."""
    m = value or os.environ.get("REPRO_AUTOTUNE") or "replay"
    if m not in MODES:
        raise ValueError(f"unknown autotune mode {m!r}; expected one of {MODES}")
    return m


def mode(pol=None) -> str:
    """The active mode for bare dispatch: an autotune field set on the
    ambient ``ExecutionPolicy`` (a scoped ``policy.apply(autotune=...)`` or
    the model's RunOptions scope; ``pol``, when the caller holds it
    already) wins, then the process override, then ``REPRO_AUTOTUNE``,
    else ``off``."""
    if pol is None:
        from repro_torch.kernels import policy

        pol = policy.current()
    if pol.autotune is not None:
        return pol.autotune
    if _mode_override is not None:
        return _mode_override
    env = os.environ.get("REPRO_AUTOTUNE", "off")
    return env if env in MODES else "off"


def set_mode(m: Optional[str]) -> None:
    """Set (or with ``None`` clear) the process-wide mode override."""
    global _mode_override
    if m is not None and m not in MODES:
        raise ValueError(f"unknown autotune mode {m!r}; expected one of {MODES}")
    _mode_override = m


@contextlib.contextmanager
def mode_scope(m: Optional[str]):
    """Temporarily pin the mode (tests, benchmark arms)."""
    global _mode_override
    prev = _mode_override
    set_mode(m)
    try:
        yield
    finally:
        _mode_override = prev


def searcher() -> bool:
    """True unless this process is a rank other than 0 of a process group
    of several: only rank 0 searches and writes the tables; the other
    ranks replay them, so no two processes write one table at once."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized() and dist.get_rank() != 0)


def startup(m: Optional[str] = None, device=None) -> str:
    """Launcher hook (serve, train): resolve and pin the mode
    **process-wide**, as JAX's does, and preload ``device``'s table
    (default: the card if there is one) so the first dispatch pays no
    I/O.  ``search`` pins ``replay`` on a rank that is not the
    :func:`searcher`."""
    resolved = resolve_mode(m)
    if resolved == "search" and not searcher():
        resolved = "replay"
    set_mode(resolved)
    if resolved != "off":
        dp = planner.device_params(device)
        log.info("autotune %s: %d tuned plan(s) for %s",
                 resolved, len(load_table(dp.kind)), dp.kind)
    return resolved


def provenance(device=None) -> dict:
    """Tuned-table provenance for startup logs and telemetry rows, JAX's
    keys: where ``device``'s table lives, whether it exists, and how many
    plans it holds."""
    dp = planner.device_params(device)
    path = table_path(dp.kind)
    return {
        "mode": resolve_mode(None),
        "device_kind": dp.kind,
        "table": str(path),
        "table_exists": path.exists(),
        "tuned_plans": len(load_table(dp.kind)),
    }


# ---------------------------------------------------------------------------
# table keys
# ---------------------------------------------------------------------------

def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(args) -> list:
    return [a for a in args if isinstance(a, torch.Tensor)]


def key_shapes(op: str, args) -> list[tuple]:
    """The operand shapes the JAX kernel sees for this call: attention's
    ``(b, s, heads, hd)`` folds to ``(b * heads, s, hd)``, as JAX's
    ``common._attention_via_kernel`` hands them to its registry."""
    shapes = [tuple(a.shape) for a in _tensors(args)]
    if op == "attention":
        shapes = [(s[0] * s[2], s[1], s[3]) for s in shapes]
    return shapes


def shape_class(*args) -> str:
    """Power-of-two bucketed shape signature (tensors or shapes): nearby
    shapes share one table entry; :func:`snap_plan` restores what the exact
    call takes at replay time."""
    shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else tuple(a) for a in args]
    return "_".join("x".join(str(_pow2_ceil(d)) for d in s) or "scalar" for s in shapes)


def sem_class(op: str, args, kwargs: Optional[dict] = None) -> str:
    """Semantic-flag suffix of the table key, as JAX's: the op's masking
    kwargs (static Python scalars; anything else keys as ``?``), plus the
    derived markers (attention: ``decode`` when sq != sk and ``kv_dtype``
    when the cache's dtype differs from q's; matmul: the ``backend``,
    forced or the planner's)."""
    kwargs = kwargs or {}
    parts = []
    for flag, default in _SEM_FLAGS.get(op, {}).items():
        v = kwargs.get(flag)
        if v is None:
            v = default
        if isinstance(v, (bool, int, str)):
            parts.append(f"{flag}={v}")
        else:
            parts.append(f"{flag}=?")
    if op == "attention":
        parts.append(f"decode={args[0].shape[1] != args[1].shape[1]}")
        if args[1].dtype != args[0].dtype:
            parts.append(f"kv_dtype={_dtype_name(args[1].dtype)}")
    if op == "matmul":
        backend = kwargs.get("backend")
        if backend is None:
            from repro_torch.kernels import registry

            backend = registry.get("matmul").plan(*args[:2]).get("backend", "classical")
        parts.append(f"backend={backend}")
    return ",".join(parts)


def entry_key(op: str, *args, kwargs: Optional[dict] = None) -> str:
    """``op|shape class|dtype|flags``, JAX's string for the same call."""
    base = f"{op}|{shape_class(*key_shapes(op, args))}|{_dtype_name(args[0].dtype)}"
    sem = sem_class(op, args, kwargs)
    return f"{base}|{sem}" if sem else base


# ---------------------------------------------------------------------------
# persisted tables (one JSON per device_kind under REPRO_TUNE_DIR)
# ---------------------------------------------------------------------------

def tune_dir() -> Path:
    return Path(os.environ.get("REPRO_TUNE_DIR") or os.path.expanduser(_DEFAULT_DIR))


def table_path(kind: Optional[str] = None) -> Path:
    kind = kind or planner.device_params().kind
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", kind) or "device"
    return tune_dir() / f"torch-{safe}.json"


def table_stamp() -> dict:
    """What a table must carry to be read (JAX's ``jax_version``): the
    running torch and the kernel sources' digest."""
    from repro_torch.kernels import _build

    return {"torch_version": torch.__version__, "kernels": _build.source_digest()}


def _valid_plan_value(v) -> bool:
    # tiles and splits are positive ints; variant knobs are the morton bool
    # and the matmul backend string
    if isinstance(v, bool):
        return True
    if isinstance(v, int):
        return v > 0
    return isinstance(v, str) and v in ("classical", "strassen")


def _valid_entry(entry) -> bool:
    return (isinstance(entry, dict) and isinstance(entry.get("plan"), dict)
            and len(entry["plan"]) > 0
            and all(_valid_plan_value(v) for v in entry["plan"].values()))


def load_table(kind: Optional[str] = None) -> dict:
    """The (cached) entries dict for one device kind.  Missing, corrupt,
    unknown-format or stale files (another table version, or a stamp from
    another torch or other kernel sources) all yield an empty table: replay
    degrades to the analytic plan, it never takes the process down."""
    kind = kind or planner.device_params().kind
    cache_key = (str(tune_dir()), kind)
    hit = _TABLE_CACHE.get(cache_key)
    if hit is not None:
        return hit
    path = table_path(kind)
    entries: dict = {}
    try:
        raw = json.loads(path.read_text())
        stamp = table_stamp()
        if not (isinstance(raw, dict) and raw.get("version") == _TABLE_VERSION
                and isinstance(raw.get("entries"), dict)):
            log.warning("autotune: ignoring table %s (unknown format)", path)
        elif any(raw.get(k) != v for k, v in stamp.items()):
            log.warning("autotune: ignoring table %s (stamped %s, running %s — treating "
                        "as cold)", path, {k: raw.get(k) for k in stamp}, stamp)
        else:
            entries = {k: v for k, v in raw["entries"].items() if _valid_entry(v)}
    except FileNotFoundError:
        pass
    except (OSError, ValueError) as exc:  # json.JSONDecodeError is ValueError
        log.warning("autotune: ignoring corrupt table %s (%s)", path, exc)
    _TABLE_CACHE[cache_key] = entries
    return entries


def save_table(kind: Optional[str] = None) -> Path:
    kind = kind or planner.device_params().kind
    entries = load_table(kind)
    path = table_path(kind)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": _TABLE_VERSION, "device_kind": kind, **table_stamp(),
               "entries": {k: entries[k] for k in sorted(entries)}}
    path.write_text(json.dumps(payload, indent=2) + "\n")
    return path


def clear_cache() -> None:
    """Drop the in-process table cache and bump :func:`generation`: call it
    after redirecting ``REPRO_TUNE_DIR`` or writing a table by hand (the
    dispatch overlay's memo sees either only then)."""
    _TABLE_CACHE.clear()
    _INTERP_LOGGED.clear()
    _GENERATION[0] += 1


# ---------------------------------------------------------------------------
# per-op tuning metadata: each knob's ladder, the analytic plan, and what
# the call's instance accepts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OpTuneInfo:
    """``knobs(*tensors)`` maps each tunable knob of this call to its range:
    ``("divides", dim)`` (a tile that must divide ``dim``) or ``("of",
    values)`` (the values the call's instance is built for).  ``analytic
    (base, *tensors)`` adds the knobs' analytic values to the registry's
    plan ``base`` (default: ``base``, whose tiles are the knobs).
    ``accepts(plan, *tensors)`` is the envelope: whether the instance
    takes the plan (default: every plan).  ``variants(base, *tensors)`` returns the
    non-tile alternatives to cross with the ladder, ``base`` first;
    ``variant_keys`` names the plan keys that replay verbatim.
    ``tiles_for(plan)``: whether a variant takes the knobs at all (the
    strassen backend takes no K2 plan)."""

    knobs: Callable[..., dict]
    analytic: Callable[..., dict] = lambda base, *args: dict(base)
    accepts: Callable[..., bool] = lambda plan, *args: True
    variants: Optional[Callable[..., list]] = None
    variant_keys: tuple = ()
    tiles_for: Callable[[dict], bool] = lambda plan: True


def _mm_instance(a, b):
    k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

    return k2.path(a, b), (a.shape[0] if a.dim() == 3 else 1)


def _matmul_knobs(a, b):
    k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

    instance, batch = _mm_instance(a, b)
    k = a.shape[-1]
    bk = k2.TILE[instance][1]
    steps = max(math.ceil(k / bk), 1)
    top = steps
    if instance == "stream":
        top = min(top, k2.STREAM_MAX_SPLITS)
    elif batch > 1:
        top = 1
    splits = sorted({k2._k_split(k, bk, s)[0] for s in range(1, top + 1)})
    return {"tile_n": ("of", tuple(k2.TILE_N[instance])), "splits": ("of", tuple(splits))}


def _matmul_analytic(base, a, b):
    k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

    if base.get("backend", "classical") != "classical":
        return dict(base)
    instance, batch = _mm_instance(a, b)
    p = k2.plan(a.shape[-2], b.shape[-1], a.shape[-1], instance, k2.sm_count(a.device), batch)
    return {**base, "tile_n": p.tile_n, "splits": p.splits}


def _matmul_accepts(plan, a, b):
    k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

    k2_plan = {key: plan[key] for key in ("tile_n", "splits") if key in plan}
    if plan.get("backend", "classical") != "classical":
        return not k2_plan
    instance, batch = _mm_instance(a, b)
    try:
        k2.check_override(a.shape[-2], b.shape[-1], a.shape[-1], instance, batch, k2_plan)
    except ValueError:
        return False
    return True


def _matmul_variants(base, a, b):
    """Backend alternatives around the analytic matmul choice, as JAX's
    (without its ``morton`` flip: K2 fixes its raster): walk the Strassen
    cutoff one octave each way, and always offer the *other* backend when
    the shape admits it."""
    base = dict(base)
    out = [base]
    if a.dim() == 3:
        return out
    n = b.shape[1]
    square = a.shape[0] == a.shape[1] == n
    if base.get("backend") == "strassen":
        cut = int(base.get("cutoff") or n)
        for c in (cut * 2, cut // 2):
            if 64 <= c < n and c != cut:
                out.append({**base, "cutoff": c})
        out.append({"backend": "classical"})
    elif (square and n % 2 == 0 and n // 2 >= 64
          and _dtype_name(a.dtype) in planner._STRASSEN_DTYPES):
        out.append({**base, "backend": "strassen", "cutoff": n // 2})
    return out


def _attention_knobs(q, k, v):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    if not fa.takes_splits(q, k):
        return {}
    tiles = -(-k.shape[1] // fa.kv_tile(q.shape[3], q.device))
    return {"splits": ("of", tuple(s for s in fa.SPLITS if s <= max(tiles, 1)))}


def _attention_analytic(base, q, k, v):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    return {**base, "splits": fa.plan_splits(q, k)} if fa.takes_splits(q, k) else dict(base)


def _attention_accepts(plan, q, k, v):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    if "splits" not in plan:
        return True
    try:
        fa.check_splits(q, k, plan["splits"])
    except ValueError:
        return False
    return True


def _scan_knobs(x):
    return {"block": ("divides", x.shape[-1])}


def _scan_accepts(plan, x):
    k5 = importlib.import_module("repro_torch.kernels.bp_scan")

    block = plan.get("block", x.shape[-1])
    segs = x.shape[0] * (x.shape[-1] // block)
    return x.shape[-1] % block == 0 and segs * -(-block // k5.tile(x.dtype)) < 2 ** 31


def _transpose_knobs(x):
    m, n = x.shape
    return {"bt": ("divides", m if m == n else math.gcd(m, n))}


def _transpose_variants(base, x):
    return [dict(base), {**base, "morton": False}]


def _fft_knobs(x):
    return {"n1": ("divides", x.shape[-1])}


def _fft_accepts(plan, x):
    k7 = importlib.import_module("repro_torch.kernels.bi_fft")

    n = x.shape[-1]
    return "n1" not in plan or k7.split(n, plan["n1"]) == (plan["n1"], n // plan["n1"])


_TUNE: dict[str, OpTuneInfo] = {
    "scan": OpTuneInfo(_scan_knobs, accepts=_scan_accepts),
    "matmul": OpTuneInfo(_matmul_knobs, _matmul_analytic, _matmul_accepts,
                         variants=_matmul_variants, variant_keys=("backend", "cutoff"),
                         tiles_for=lambda p: p.get("backend", "classical") == "classical"),
    "transpose": OpTuneInfo(_transpose_knobs, variants=_transpose_variants,
                            variant_keys=("morton",)),
    "attention": OpTuneInfo(_attention_knobs, _attention_analytic, _attention_accepts),
    "fft": OpTuneInfo(_fft_knobs, accepts=_fft_accepts),
}


def tunable_ops() -> list[str]:
    return sorted(_TUNE)


def variant_keys(op: str) -> tuple:
    """The op's non-tile plan knobs (backend/cutoff/morton).  Dispatch feeds
    forced variant overrides back into the table lookup through this, so a
    call that pins ``backend="classical"`` replays the classical entry."""
    info = _TUNE.get(op)
    return info.variant_keys if info else ()


def tunable(op: str, *args) -> bool:
    """Whether this call has anything to tune: a knob its instance reads,
    or a variant (an attention call off K1q's tensor cores has neither)."""
    info = _TUNE.get(op)
    return info is not None and (bool(info.knobs(*args)) or info.variants is not None)


def analytic_plan(op: str, *args, kwargs: Optional[dict] = None) -> dict:
    """The plan the call runs untuned: the registry's plan, under the
    call's forced variant knobs, with each knob's analytic value."""
    from repro_torch.kernels import registry  # the layer below; lazy to stay acyclic

    base = dict(registry.get(op).plan(*args))
    base.update({k: v for k, v in (kwargs or {}).items()
                 if k in variant_keys(op) and v is not None})
    return _TUNE[op].analytic(base, *args)


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------

def _snap_knob(rng, v: int) -> int:
    kind, arg = rng
    if kind == "divides":
        return planner.divisor_tile(arg, int(v))
    below = [x for x in arg if x <= v]
    return max(below) if below else min(arg)


def snap_plan(op: str, args, plan: dict) -> dict:
    """Clamp a tuned plan (possibly recorded for a same-class neighbour
    shape, or another instance) back to what this call takes: a divisor
    tile becomes the largest divisor of its axis not above the tuned
    value, a knob with a set of values the largest not above it; variant
    knobs replay verbatim (the wrappers gate their own eligibility).  If
    the snapped knobs still do not fit the instance, only the variants
    replay."""
    info = _TUNE[op]
    knobs = info.knobs(*args)
    out = {k: v for k, v in plan.items() if k in info.variant_keys}
    tiles = ({k: _snap_knob(knobs[k], v) for k, v in plan.items() if k in knobs}
             if info.tiles_for(out) else {})
    if tiles and not info.accepts({**out, **tiles}, *args):
        tiles = {}
    return {**out, **tiles}


# octaves each knob's ladder spans on either side of its analytic value
_SPAN = 2


def candidates(op: str, *args, max_candidates: int = 16,
               kwargs: Optional[dict] = None) -> list[dict]:
    """Power-of-two ladder around the analytic plan: each knob ranges over
    factor 2**±``_SPAN`` of its analytic value (snapped to its range), the
    cross product is filtered by what the instance accepts, crossed with
    the op's variants (backend/cutoff, morton; a forced variant knob in
    ``kwargs`` fixes its key), and ranked by log-distance from the analytic
    point (each variant hop counts one octave, a variant at the analytic
    knobs right behind the analytic plan).  The analytic plan is always
    candidate 0.  The envelope is the instance's, which the tensors carry
    (JAX takes device parameters for its VMEM model)."""
    info = _TUNE[op]
    analytic = analytic_plan(op, *args, kwargs=kwargs)
    knobs = info.knobs(*args)
    forced = {k: v for k, v in (kwargs or {}).items()
              if k in info.variant_keys and v is not None}
    tile_analytic = {k: v for k, v in analytic.items() if k in knobs}
    variant_analytic = {k: v for k, v in analytic.items() if k not in knobs}

    ladders: dict[str, list[int]] = {}
    for key, base in tile_analytic.items():
        vals = set()
        for shift in range(-_SPAN, _SPAN + 1):
            target = base << shift if shift >= 0 else max(base >> -shift, 1)
            vals.add(_snap_knob(knobs[key], target))
        ladders[key] = sorted(vals)

    keys = sorted(ladders)
    tile_plans = [tile_analytic]
    for combo in itertools.product(*(ladders[k] for k in keys)):
        plan = dict(zip(keys, combo))
        if plan != tile_analytic:
            tile_plans.append(plan)

    variants = ([dict(variant_analytic)] if info.variants is None
                else info.variants(variant_analytic, *args))
    variants = [v for v in variants if all(v.get(k, forced[k]) == forced[k] for k in forced)]

    def dist(p: dict) -> float:
        return sum(abs(math.log2(p[k]) - math.log2(max(tile_analytic[k], 1)))
                   for k in keys if k in p)

    def order_key(plan: dict):
        return tuple(sorted((k, str(v)) for k, v in plan.items()))

    scored, seen = [], set()
    for vi, var in enumerate(variants):
        for ti, tiles in enumerate(tile_plans):
            plan = {**(tiles if info.tiles_for(var) else {}), **var}
            key = order_key(plan)
            if key in seen or not info.accepts(plan, *args):
                continue
            seen.add(key)
            score = vi / 10.0 if (vi and ti == 0) else dist(plan) + vi
            scored.append((score, plan))
    scored.sort(key=lambda t: (t[0], order_key(t[1])))
    rest = [p for _, p in scored if p != analytic]
    return [analytic] + rest[:max(max_candidates - 1, 0)]


# ---------------------------------------------------------------------------
# timing harness
# ---------------------------------------------------------------------------

# device cycles the stream spins before a timed batch of calls, so the host
# has queued every call before the first one starts (~1 ms on an H100)
_LEAD_CYCLES = 2_000_000
# device µs a timed sample covers at least (calls are batched up to it)
_SAMPLE_US = 200.0


def measure_us(fn, args, *, iters: int = 5, kwargs: Optional[dict] = None) -> float:
    """Median-of-``iters`` time of one ``fn(*args, **kwargs)`` in
    microseconds (:func:`_samples`)."""
    return statistics.median(_samples(fn, args, iters=iters, kwargs=kwargs))


def _samples(fn, args, *, iters: int, kwargs: Optional[dict] = None) -> list[float]:
    """``iters`` times of one ``fn(*args, **kwargs)`` in microseconds, under
    ``no_grad``, after one warm-up call (which also absorbs a kernel's first
    build).  On the card each sample is the device time between two CUDA
    events of a batch of calls queued behind a short spin kernel (so the
    host's launch cost stays out), divided by the batch; on the CPU it is
    the wall time of one call."""
    kwargs = kwargs or {}
    device = _tensors(args)[0].device
    samples = []
    with torch.no_grad():
        if device.type != "cuda":
            fn(*args, **kwargs)
            for _ in range(max(iters, 1)):
                t0 = time.perf_counter()
                fn(*args, **kwargs)
                samples.append((time.perf_counter() - t0) * 1e6)
            return samples
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        reps = max(1, min(20, math.ceil(_SAMPLE_US / max(start.elapsed_time(end) * 1e3, 1.0))))
        for _ in range(max(iters, 1)):
            if hasattr(torch.cuda, "_sleep"):
                torch.cuda._sleep(_LEAD_CYCLES)
            start.record()
            for _ in range(reps):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3 / reps)
    return samples


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph (no
    search may run then: it would sync).  False on a build without CUDA."""
    try:
        return bool(torch.cuda.is_current_stream_capturing())
    except RuntimeError:
        return False


def _kind(args) -> str:
    return planner.device_params(_tensors(args)[0].device).kind


def search(op: str, *args, iters: int = 5, max_candidates: int = 16, **kwargs) -> dict:
    """Time the candidate ladder for one call on its own tensors (the
    kernel on the card, the plain version on the CPU), record the winner in
    the device's table, save it and return the table entry.  The analytic
    plan is timed again after the ladder; a winner that beats it by no more
    than the spread of its samples from both timings is noise, and the
    entry records the analytic plan (JAX records the fastest candidate
    whatever the margin).  ``kwargs``: the call's semantic kwargs (and
    forced variant knobs); a caller's ``out=`` is never written.  A
    candidate that fails raises (JAX's skips it): the ladder holds only
    plans the instance accepts."""
    from repro_torch.kernels import registry

    if capturing():
        raise RuntimeError(f"autotune.search({op!r}) during CUDA graph capture; "
                           "a search syncs the stream")
    spec = registry.get(op)
    cands = candidates(op, *args, max_candidates=max_candidates, kwargs=kwargs)
    call_kw = {k: v for k, v in kwargs.items() if k != "out"}
    samples = [_samples(spec.kernel, args, iters=iters, kwargs={**call_kw, **plan})
               for plan in cands]
    timed = [(statistics.median(s), plan) for s, plan in zip(samples, cands)]
    best_us, best = min(timed, key=lambda t: t[0])
    analytic_us, analytic = timed[0]
    again = _samples(spec.kernel, args, iters=iters, kwargs={**call_kw, **analytic})
    spread = max(samples[0] + again) - min(samples[0] + again)
    if analytic_us - best_us <= spread:
        best_us, best = analytic_us, analytic
    entry = {
        "plan": best,
        "us": round(best_us, 1),
        "analytic_plan": analytic,
        "analytic_us": round(analytic_us, 1),
        "iters": iters,
        "candidates": len(cands),
    }
    kind = _kind(args)
    load_table(kind)[entry_key(op, *args, kwargs=kwargs)] = entry
    _GENERATION[0] += 1
    save_table(kind)
    return entry


# ---------------------------------------------------------------------------
# dispatch-time overlay (the integration point for registry.dispatch)
# ---------------------------------------------------------------------------

def lookup(op: str, *args, kwargs: Optional[dict] = None) -> Optional[dict]:
    """The persisted tuned plan for this op/shape class/dtype/flags on the
    call's device kind, or None."""
    entry = load_table(_kind(args)).get(entry_key(op, *args, kwargs=kwargs))
    return dict(entry["plan"]) if entry else None


# (tune_dir, wanted key, borrowed key) triples already logged
_INTERP_LOGGED: set[tuple] = set()


def _shape_distance(a: str, b: str) -> Optional[float]:
    """Log2 distance between two ``shape_class`` strings; None when the
    tensor structures differ (different arity or rank)."""
    pa, pb = a.split("_"), b.split("_")
    if len(pa) != len(pb):
        return None
    total = 0.0
    for xa, xb in zip(pa, pb):
        da, db = xa.split("x"), xb.split("x")
        if len(da) != len(db):
            return None
        for u, v in zip(da, db):
            if u == "scalar" or v == "scalar":
                if u != v:
                    return None
                continue
            total += abs(math.log2(int(u)) - math.log2(int(v)))
    return total


def nearest_plan(op: str, *args, kwargs: Optional[dict] = None) -> Optional[dict]:
    """Cross-shape interpolation: on an exact-key miss, borrow the tuned
    plan of the *nearest* recorded shape class with the same ``(op, dtype,
    flags)``.  Logs once per borrowed key."""
    table = load_table(_kind(args))
    if not table:
        return None
    want = entry_key(op, *args, kwargs=kwargs)
    wop, wshape, wrest = want.split("|", 2)
    best = None
    for key, entry in table.items():
        try:
            kop, kshape, krest = key.split("|", 2)
        except ValueError:
            continue
        if kop != wop or krest != wrest or kshape == wshape:
            continue
        d = _shape_distance(wshape, kshape)
        if d is None:
            continue
        if best is None or (d, key) < (best[0], best[1]):
            best = (d, key, entry)
    if best is None:
        return None
    _, key, entry = best
    tag = (str(tune_dir()), want, key)
    if tag not in _INTERP_LOGGED:
        _INTERP_LOGGED.add(tag)
        log.info("autotune: no tuned entry for %s; interpolating from "
                 "nearest recorded class %s", want, key)
    return dict(entry["plan"])


def _overlay(op: str, args, search_kwargs: Optional[dict] = None) -> tuple[dict, bool]:
    """:func:`overlay`, and whether its answer may be memoized (not when a
    search was due but the stream was being captured)."""
    m = mode()
    if m == "off" or not tunable(op, *args):
        return {}, True
    if m == "search" and not searcher():
        m = "replay"
    final = True
    plan = lookup(op, *args, kwargs=search_kwargs)
    if plan is None and m == "search":
        if capturing():
            final = False
        else:
            plan = dict(search(op, *args, **(search_kwargs or {}))["plan"])
    if plan is None:
        plan = nearest_plan(op, *args, kwargs=search_kwargs)
    if plan is None:
        return {}, final
    return snap_plan(op, args, plan), final


def overlay(op: str, args, *, search_kwargs: Optional[dict] = None) -> dict:
    """Tuned knobs to merge over the analytic plan (empty when the mode is
    off, the call has nothing to tune, or the cache is cold).  In
    ``search`` mode a miss outside a CUDA graph capture triggers an in-line
    search; otherwise a miss falls back to cross-shape interpolation
    (:func:`nearest_plan`) before going cold."""
    return _overlay(op, args, search_kwargs)[0]
