"""The port's kernels, written by hand in CUDA C++ for Hopper (``sm_90a``),
and the registry that dispatches them.

``registry.dispatch(name, *tensors, **kwargs)`` is the public kernel API,
as ``repro.kernels.dispatch`` is the JAX package's: one op namespace
(``scan``, ``matmul``, ``transpose``, ``attention``, ``fft``), the backend
chosen by the ambient policy (``policy.py``, ``--impl``) and by the device
of the call's tensors (``registry.route``: a CUDA tensor runs the kernel,
a CPU tensor its plain version; the oracle only on CPU tensors), and the
tiles by the planner (``planner.py``) from the device's parameters.  The
models dispatch ``matmul`` and ``attention`` through it.

- ``hbp_matmul`` (K2, ``csrc/hbp_matmul.cu``) replaces
  ``repro/kernels/hbp_matmul.py:_mm_kernel``: every matrix product.
- ``strassen_matmul`` (K4, ``csrc/strassen_matmul.cu`` for f32: up to two
  levels of the recursion fused into one launch; bf16 over K2) replaces
  ``repro/kernels/strassen_matmul.py``; its ``matmul`` is the registry's
  ``matmul`` op (classical or Strassen by the planner, differentiable).
- ``flash_attention`` (K1, ``csrc/flash_attention.cu``),
  ``flash_attention_int8`` (K1q, the same source with int8 K/V) and
  ``flash_attention_bwd`` (K3, ``csrc/flash_attention_bwd.cu``) replace
  ``repro/kernels/flash_attention.py``'s forward and backward kernels.
- ``bp_scan`` (K5, ``csrc/bp_scan.cu``) replaces
  ``repro/kernels/bp_scan.py``: the blocked prefix scan, one chained pass.
- ``bi_transpose`` (K6, ``csrc/bi_transpose.cu``) replaces
  ``repro/kernels/bi_transpose.py``: the Morton-ordered tiled transpose.
- ``bi_fft`` (K7, ``csrc/bi_fft.cu``) replaces ``repro/kernels/bi_fft.py``:
  the four-step split, each small DFT a radix-4 FFT in shared memory, in
  two passes (past a pass's 4096 lines, pass 2 a nested call read out by
  K6).

Each wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors, counts its kernel calls in ``<wrapper>.launches``, and builds its
kernel on first use (``_build.py``).  The names above are exported as
functions, which shadow the modules of the same names as attributes of
this package: reach a module with ``importlib.import_module``.  Nothing
here imports JAX or the ``repro`` package.
"""
from repro_torch.kernels import morton, planner, policy, ref, registry
from repro_torch.kernels.bi_fft import bi_fft
from repro_torch.kernels.bi_transpose import bi_transpose
from repro_torch.kernels.bp_scan import bp_scan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hbp_matmul import hbp_matmul
from repro_torch.kernels.policy import ExecutionPolicy
from repro_torch.kernels.registry import dispatch, resolve
from repro_torch.kernels.strassen_matmul import strassen_matmul

__all__ = [
    "morton",
    "planner",
    "policy",
    "ref",
    "registry",
    "ExecutionPolicy",
    "dispatch",
    "resolve",
    "bp_scan",
    "bi_transpose",
    "bi_fft",
    "flash_attention",
    "hbp_matmul",
    "strassen_matmul",
]
