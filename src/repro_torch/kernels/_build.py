"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C function.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/<name>-<hash>.so``
under the repository root (listed in ``.gitignore``) on first use, and loaded
with ``ctypes``; the wrappers pass tensor pointers, sizes and PyTorch's
current stream as plain integers.  The file name carries a hash of the
source, of every shared header ``csrc/*.cuh`` and of the flags, so an edited
source or header is rebuilt and an unchanged one is not.  :func:`build`
starts one ``nvcc`` per source, all at once.

No PyTorch headers are compiled, which keeps a build to seconds.  Nothing is
built or loaded at import time: this module imports on a machine with no
CUDA toolkit, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_THREAD = threading.local()


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every header under ``csrc/`` (any source may include any of
    them) and of the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def source_digest() -> str:
    """One digest of every kernel source, shared header and flag: the
    hashes :func:`library_path` names each library by, hashed together.
    A kernel's measured timings hold for this digest only (the autotune
    stamps its tables with it)."""
    digest = hashlib.sha256()
    for name in sources():
        digest.update(library_path(name).name.encode() + b"\0")
    return digest.hexdigest()[:16]


def build(names=None) -> dict[str, str]:
    """Compile each named source (default: all) whose library is missing,
    one ``nvcc`` process per source, all started together.  Returns the
    compiler's output (``-Xptxas=-v``: registers, shared memory, spills) for
    each source it compiled; raises with the log if any compile fails."""
    names = sources() if names is None else list(names)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs, errors = {}, []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, for
    a launch from the calling thread.

    Each library links its own CUDA runtime, which launches into the
    calling thread's current context.  A thread that has not yet run a CUDA
    call through PyTorch may have none: autograd's backward thread, whose
    first call in a backward can be a kernel of ours (the batched K2's
    ``dA``), or any new Python thread.  Every launch there fails with
    ``cudaErrorInvalidValue``.  So the first load on each thread makes
    PyTorch's current device's context current on it
    (``torch.cuda.set_device``, which the thread's device does not
    change)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    if not getattr(_THREAD, "bound", False):
        torch.cuda.set_device(torch.cuda.current_device())
        _THREAD.bound = True
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
