"""Checkpoints in ``repro``'s on-disk format, without JAX: the counterpart
of ``repro/checkpoint/checkpoint.py``, read and write side.

``repro`` keeps a model's parameters as a pytree whose per-layer leaves
are stacked along a leading layer axis (``layers/wq`` is ``(L, d,
q_dim)``; the hybrid stacks its groups, ``groups/rec1/w_x``,
``groups/rec2/...``, ``groups/attn/...`` and ``tail_rec/...``; the
encoder-decoder its ``encoder`` and ``decoder``, whose leaves are nested
dicts, ``decoder/self_attn/wq``; the VLM its ``cross_layers`` and, twice,
its ``self_layers``, ``(n_super, n_self, ...)``).  The port holds one
module per layer (``layers.<i>.wq``, ``groups.rec1.<i>.w_x``,
``decoder.<i>.self_attn.wq``, ``self_layers.<s>.<j>.wq``).
:func:`params_from_numpy` converts the pytree, as numpy arrays, into the
port's state dict by unstacking each stacked group's leading axes;
:func:`load_repro_checkpoint` does the same from a checkpoint directory of
a parameter pytree.

The format (``repro.checkpoint.save_checkpoint``): ``<dir>/step_<N>/``
holds one ``.npy`` per leaf, ``leaf_<i>.npy`` in the order of the tree's
``/``-joined leaf names with each dict's keys sorted (``jax.tree_util``'s
order), bf16 stored as its uint16 bits, and ``manifest.json`` with the
step, the mesh shape and, per leaf, its name, file, logical dtype, shape
and the SHA-256 of its file.  A save writes ``step_<N>.tmp/`` and renames
it, so a crash mid-save leaves the last complete checkpoint as it was, and
keeps the last ``keep`` steps.

The write side takes a state in the port's form, nested dicts whose leaves
are tensors (or numpy arrays) and whose innermost keys may be the port's
parameter names: the trainer's ``{"params": {name: tensor}, "opt_state":
{"step", "master", "m", "v"}}``.  Every ``<group>.<i>.<x>`` of one dict
(``layers``, ``groups.rec1``, ``tail_rec``, ``decoder``, ...) is stacked
into the leaf ``.../<group>/<x>`` of shape ``(n, ...)`` (every
``self_layers.<s>.<j>.<x>`` into ``(n_super, n_self, ...)``), and any
other ``.`` in a name becomes a ``/``, so the files carry the JAX tree's
names and shapes: ``repro.checkpoint.load_checkpoint`` reads them into the
JAX ``{"params", "opt_state"}`` tree, and :func:`load_checkpoint` reads
what JAX's ``save_checkpoint`` wrote for that tree.  ``mesh_shape`` is
the writer's mesh as ``{axis: size}`` (the trainer's and the router's, as
JAX writes it; ``{}`` when none is given).

A sharded state (leaves that are blocks, ``core/planner.py``'s
``Placement``) is saved whole: every rank of the mesh gathers each leaf in
turn (:func:`_whole_on_host`), rank 0 of the mesh writes, and the others
wait for it at :meth:`CheckpointManager.wait`.  A restore into blocks reads
each whole leaf on every rank and keeps the rank's block of it
(:func:`_place_leaf`): no collective, and the checkpoint restores onto any
mesh whatever mesh wrote it.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str] = None) -> torch.Tensor:
    """numpy -> torch, keeping bf16 bit-exact: a bf16 array (ml_dtypes, or
    raw uint16 bits with ``dtype_name == "bfloat16"``) goes through uint16."""
    if dtype_name == "bfloat16" or str(arr.dtype) == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(x) -> np.ndarray:
    """A leaf on the host as numpy, always a copy (the trainer updates its
    tensors in place after a snapshot); bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def _logical_dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


# the JAX trees' layer-stacked groups and the number of stacked axes of
# each: the dense and SSM models' ``layers``, the hybrid's superblock groups
# and its tail (``repro/models/hybrid.py``), the encoder-decoder's stacks
# (``encdec.py``) and the VLM's superblocks (``vlm.py``), whose self layers
# are stacked twice, (n_super, n_self, ...)
STACKED = {"layers": 1, "groups/rec1": 1, "groups/rec2": 1, "groups/attn": 1,
           "tail_rec": 1, "encoder": 1, "decoder": 1, "self_layers": 2,
           "cross_layers": 1}


def _stacked_group(name: str) -> Optional[str]:
    """The stacked group a ``/``-joined pytree name lies under, or None."""
    return next((g for g in STACKED if name.startswith(g + "/")), None)


def _unstack(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``/``-joined pytree names -> the port's state dict: a stacked
    group's ``<group>/<x>`` of shape (n, ...) becomes ``<group>.<i>.<x>``
    for each i, (n1, n2, ...) under a group stacked twice
    ``<group>.<i>.<j>.<x>``, with ``.`` for ``/`` (``<x>`` may itself be a
    path: ``decoder/self_attn/wq`` -> ``decoder.<i>.self_attn.wq``)."""
    out = {}
    for name, t in flat.items():
        group = _stacked_group(name)
        if group is None:
            out[name.replace("/", ".")] = t
            continue
        leaf = name[len(group) + 1:].replace("/", ".")
        lead = t.shape[:STACKED[group]]
        for idx in itertools.product(*map(range, lead)):
            out[".".join([group.replace("/", "."), *map(str, idx), leaf])] = t[idx].clone()
    return out


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> ``{"/"-joined path: leaf}``, each dict's keys in
    sorted order (the order ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        flat = {}
        for key in sorted(tree):
            flat.update(_flatten(tree[key], f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def _repro_name(path: str) -> tuple[str, Optional[tuple]]:
    """A flattened path of the port's state -> (the JAX tree's leaf name,
    the layer index tuple or None): ``opt_state/m/layers.3.wq`` ->
    (``opt_state/m/layers/wq``, (3,)), ``params/groups.rec1.2.w_x`` ->
    (``params/groups/rec1/w_x``, (2,)), ``params/self_layers.1.2.wq`` ->
    (``params/self_layers/wq``, (1, 2)), ``params/decoder.0.mlp.w_up`` ->
    (``params/decoder/mlp/w_up``, (0,)), ``params/final_norm`` -> itself."""
    head, _, last = path.rpartition("/")
    parts = last.split(".")
    layer = None
    for k in range(1, len(parts)):
        depth = STACKED.get("/".join(parts[:k]))
        idx = parts[k:k + depth] if depth else []
        if depth and len(parts) > k + depth and all(p.isdigit() for p in idx):
            layer = tuple(map(int, idx))
            parts = parts[:k] + parts[k + depth:]
            break
    return "/".join(([head] if head else []) + parts), layer


def _repro_leaves(state) -> dict[str, list]:
    """The JAX tree's leaf names, in its flattening order, each with its
    sources: ``[(layer, leaf), ...]`` for a stacked leaf (``layer`` an index
    tuple, the sources in index order), ``[(None, leaf)]`` for any other."""
    groups: dict[str, list] = {}
    for path, leaf in _flatten(state).items():
        name, layer = _repro_name(path)
        groups.setdefault(name, []).append((layer, leaf))
    for name, srcs in groups.items():
        if srcs[0][0] is None:
            if len(srcs) > 1:
                raise ValueError(f"{name}: {len(srcs)} leaves of one name")
            continue
        srcs.sort(key=lambda s: s[0])
        grid = [i + 1 for i in srcs[-1][0]]
        if [i for i, _ in srcs] != list(itertools.product(*map(range, grid))):
            raise ValueError(f"{name}: layers {[i for i, _ in srcs]} do not fill {tuple(grid)}")
    return {name: groups[name] for name in sorted(groups, key=lambda n: n.split("/"))}


def _host_tree(state) -> dict[str, tuple[np.ndarray, str]]:
    """The state on the host in the JAX tree's names and shapes (layer
    leaves stacked), each leaf ``(array, logical dtype)``: the snapshot a
    save writes, its leaves copied on a few threads."""
    leaves = _repro_leaves(state)
    return dict(zip(leaves, _each(_host_leaf, leaves.values())))


def _host_leaf(srcs: list) -> tuple[np.ndarray, str]:
    first = srcs[0][1]
    if srcs[0][0] is None:
        return _to_numpy(first), _logical_dtype(first)
    one = _to_numpy(first)
    grid = tuple(i + 1 for i in srcs[-1][0])
    arr = np.empty(grid + one.shape, dtype=one.dtype)
    arr[srcs[0][0]] = one
    for idx, leaf in srcs[1:]:
        arr[idx] = _to_numpy(leaf)
    return arr, _logical_dtype(first)


def _sha256(path: Path) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def _each(fn, items) -> list:
    """``fn`` over ``items`` on a few threads, results in order: writing and
    hashing a leaf release the GIL, and a full-width state's leaves take
    seconds each to hash one at a time."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


# leaves read ahead of the one being placed (load_checkpoint)
READ_AHEAD = 8


def _step_dirs(directory: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if not p.name.endswith(".tmp"))


def _write(directory: Path, step: int, host: dict, mesh_shape: Optional[dict],
           keep: int) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    def one(item):
        i, (name, (arr, dtype)) = item
        fn = f"leaf_{i:05d}.npy"
        np.save(tmp / fn, arr)
        return {"name": name, "file": fn, "dtype": dtype, "shape": list(arr.shape),
                "sha256": _sha256(tmp / fn)}

    manifest = {"step": step, "mesh_shape": mesh_shape or {},
                "leaves": _each(one, enumerate(host.items()))}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    for old in _step_dirs(directory)[:-keep]:
        shutil.rmtree(directory / f"step_{old}", ignore_errors=True)
    return final


def save_checkpoint(directory, step: int, state: Any, mesh_shape: Optional[dict] = None,
                    keep: int = 3) -> Path:
    """Write ``state`` (see the module docstring) as ``<directory>/step_<step>``
    in ``repro``'s format, then keep the last ``keep`` steps.  Returns the
    step's directory.  A sharded state is saved as
    :meth:`CheckpointManager.save_async` saves it, and waited for."""
    if _mesh_of(state) is not None:
        mgr = CheckpointManager(directory, keep)
        mgr.save_async(step, state, mesh_shape)
        mgr.wait()
        return Path(directory) / f"step_{step}"
    return _write(Path(directory), step, _host_tree(state), mesh_shape, keep)


def latest_step(directory) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    steps = _step_dirs(Path(directory))
    return steps[-1] if steps else None


def _step_dir(directory, step: Optional[int]) -> Path:
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return directory / f"step_{step}"


def _read_leaf(d: Path, entry: dict, verified: bool = False) -> torch.Tensor:
    """One leaf as a CPU tensor of its logical dtype, its checksum checked
    (unless already ``verified``) and its shape held to the manifest's."""
    path = d / entry["file"]
    if not verified and _sha256(path) != entry["sha256"]:
        raise IOError(f"checksum mismatch for {entry['name']}")
    arr = np.load(path)
    if list(arr.shape) != list(entry["shape"]):
        raise ValueError(f"shape mismatch {entry['name']}: {arr.shape} vs {entry['shape']}")
    return _to_tensor(arr, entry["dtype"])


def load_checkpoint(directory, state_like: Any, step: Optional[int] = None, *,
                    in_place: bool = False) -> tuple[int, Any]:
    """Restore ``<directory>/step_<step>`` (default: the latest) into the
    structure of ``state_like`` (the port's form, as :func:`save_checkpoint`
    takes it).  Each leaf is read by its JAX tree name (a layer's slice of a
    stacked leaf), its checksum checked, its shape held to its like's, and
    cast to its like's dtype on its like's device.  Returns ``(step,
    state)``.  ``in_place`` copies into ``state_like``'s own tensors and
    returns ``state_like`` (the trainer's parameters and AdamW state, so the
    card holds one copy).  Every checksum is checked before the first leaf
    is read, so a corrupt file leaves the state as it was."""
    d = _step_dir(directory, step)
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}
    wanted = _repro_leaves(state_like)
    missing = [name for name in wanted if name not in by_name]
    if missing:
        raise KeyError(f"{d}: no leaves {missing}")
    digests = _each(lambda name: _sha256(d / by_name[name]["file"]), wanted)
    for name, digest in zip(wanted, digests):
        if digest != by_name[name]["sha256"]:
            raise IOError(f"checksum mismatch for {name}")
    restored = {}
    names = list(wanted)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        # leaves are read (np.load, bf16 bits copied) on the pool up to
        # READ_AHEAD ahead, and placed here in order: a full-width state's
        # leaves take seconds each to read one at a time
        ahead: dict = {}
        for i, name in enumerate(names):
            for nxt in names[i:i + READ_AHEAD]:
                if nxt not in ahead:
                    ahead[nxt] = pool.submit(_read_leaf, d, by_name[nxt], True)
            _place_leaf(name, ahead.pop(name).result(), wanted[name], in_place, restored)
    if in_place:
        return manifest["step"], state_like

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {key: rebuild(sub, f"{prefix}{key}/") for key, sub in tree.items()}
        return restored[_repro_name(prefix[:-1])]

    return manifest["step"], rebuild(state_like)


def _place_leaf(name: str, arr: torch.Tensor, srcs: list, in_place: bool,
                restored: dict) -> None:
    """A read leaf into its likes: copied into them (``in_place``), else
    into ``restored`` by (name, layer), on each like's device and dtype; a
    like that is a block gets its block of the leaf (and the new tensor the
    like's placement)."""
    from repro_torch.core import planner

    for layer, like in srcs:
        t = arr if layer is None else arr[layer]
        pl = planner.placement(like)
        like_shape = tuple(like.shape) if pl is None else pl.full
        if tuple(t.shape) != like_shape:
            raise ValueError(f"shape mismatch {name}: {tuple(t.shape)} vs {like_shape}")
        if pl is not None:
            t = pl.cut(t)
        if in_place:
            with torch.no_grad():
                like.copy_(t)
        else:
            restored[(name, layer)] = planner.tag(
                t.to(device=like.device, dtype=like.dtype, copy=True), pl)


def _mesh_of(state) -> Any:
    """The mesh of the first leaf of ``state`` that is a block of a split
    or replicated tensor (None: a whole state)."""
    from repro_torch.core import planner

    for leaf in _flatten(state).values():
        pl = planner.placement(leaf)
        if pl is not None:
            return pl.mesh
    return None


def _whole_on_host(state) -> Any:
    """``state`` with every block gathered whole and copied to the host,
    leaf by leaf in the tree's order (every rank of the mesh must call
    it): the device holds one whole leaf at a time."""
    from repro_torch.core import planner

    if isinstance(state, dict):
        return {k: _whole_on_host(v) for k, v in state.items()}
    if planner.placement(state) is None:
        return state
    return planner.gather(state).cpu()


class CheckpointManager:
    """Async save and restore-latest (JAX ``checkpoint.py:130-163``).
    :meth:`save_async` snapshots the state to the host before it returns,
    so the trainer may update its tensors in place at once, and writes in a
    background thread; an error there surfaces at the next :meth:`wait`."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None  # the mesh of a sharded save not yet waited for

    def save_async(self, step: int, state: Any, mesh_shape: Optional[dict] = None) -> None:
        """Snapshot ``state`` to the host and write it in the background.
        A sharded state is gathered whole first, on every rank of its mesh
        (a collective: every rank calls this), and written by rank 0 of
        the mesh; every rank waits for that write at the next
        :meth:`wait`."""
        self.wait()
        mesh = _mesh_of(state)
        if mesh is not None:
            state = _whole_on_host(state)
            self._mesh = mesh
            if any(int(c) for c in mesh.get_coordinate()):
                return  # rank 0 of the mesh writes
        host = _host_tree(state)

        def work():
            try:
                _write(self.directory, step, host, mesh_shape, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the pending write (and, after a sharded save, for every
        rank of its mesh); raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._mesh is not None:
            from repro_torch.core import collectives

            mesh, self._mesh = self._mesh, None
            collectives.barrier(mesh)

    def restore_latest(self, state_like: Any, *, in_place: bool = False):
        return load_checkpoint(self.directory, state_like, in_place=in_place)


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """``repro``'s parameter pytree (nested dicts of numpy arrays,
    layer-stacked) -> the port's state dict, on the CPU."""
    return _unstack({name: _to_tensor(np.asarray(leaf))
                     for name, leaf in _flatten(tree).items()})


def load_repro_checkpoint(directory, step: Optional[int] = None) -> dict[str, torch.Tensor]:
    """Read ``<directory>/step_<step>`` (default: the latest step) as written
    by ``repro.checkpoint.save_checkpoint`` for a parameter pytree, verify
    every leaf's checksum, and return the port's state dict (CPU tensors)."""
    d = _step_dir(directory, step)
    manifest = json.loads((d / "manifest.json").read_text())
    return _unstack({leaf["name"]: _read_leaf(d, leaf) for leaf in manifest["leaves"]})
