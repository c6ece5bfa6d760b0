"""The plain PyTorch versions of the port's kernels, in one place: the
counterpart of ``repro.kernels.ref``.  Each lives beside its kernel; the
wrappers take them for tensors on the CPU, and ``chip_smoke.py`` holds each
kernel against its plain version on the card."""
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.kernels.hbp_matmul import matmul_ref

__all__ = ["flash_attention_bwd_ref", "flash_attention_ref", "matmul_ref"]
