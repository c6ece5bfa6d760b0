"""The port's kernels, written by hand in CUDA C++ for Hopper (``sm_90a``).

- ``hbp_matmul`` (``csrc/hbp_matmul.cu``) replaces
  ``repro/kernels/hbp_matmul.py:_mm_kernel``: every projection and the
  tied logits.
- ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``repro/kernels/flash_attention.py:_flash_kernel``: prefill and decode
  attention.

Each wrapper runs its plain version (``ref.py``) on CPU tensors and its
kernel on CUDA tensors, counts its launches in ``<wrapper>.launches``, and
builds its kernel on first use (``_build.py``).  Nothing here imports JAX or
the ``repro`` package.
"""
