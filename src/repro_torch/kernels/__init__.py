"""The port's kernels, written by hand in CUDA C++ for Hopper (``sm_90a``).

- ``hbp_matmul`` (``csrc/hbp_matmul.cu``) replaces
  ``repro/kernels/hbp_matmul.py:_mm_kernel``: every projection and the
  tied logits, forward and backward (``hbp_matmul.matmul``).
- ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``repro/kernels/flash_attention.py:_flash_kernel``: prefill, decode and
  training attention.
- ``flash_attention_int8`` (K1q, the same source with int8 K/V) replaces
  ``_flash_kernel`` with ``quantized=True``: decode and continuation
  chunks over the int8 KV cache.
- ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) replaces
  ``repro/kernels/flash_attention.py:_bwd_dq_kernel`` and
  ``:_bwd_dkv_kernel``: the attention backward in training.

Each wrapper runs its plain version (``ref.py``) on CPU tensors and its
kernel on CUDA tensors, counts its launches in ``<wrapper>.launches``, and
builds its kernel on first use (``_build.py``).  ``policy.py`` is the
execution policy (``--impl``) the models read.  Nothing here imports JAX or
the ``repro`` package.
"""
