"""The plain PyTorch oracles, in one place: the counterpart of
``repro.kernels.ref`` and the registry's ``ref``/``jnp`` backends.  Each
lives beside its kernel.  ``bp_scan_ref`` rounds once where K5 and its plain
version ``bp_scan_plain`` round twice (the TPU kernel's leaf structure);
``transpose_ref`` is K6's plain version too (the transpose is exact);
``fft_ref`` is ``torch.fft.fft``, beside K7's two-pass ``bi_fft_plain``.
``flash_attention_ref`` returns ``(out, lse)``; the registry's attention
oracle keeps ``out``."""
from repro_torch.kernels.bi_fft import fft_ref
from repro_torch.kernels.bi_transpose import transpose_ref
from repro_torch.kernels.bp_scan import bp_scan_ref
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.kernels.hbp_matmul import matmul_ref

__all__ = ["bp_scan_ref", "fft_ref", "flash_attention_bwd_ref", "flash_attention_ref",
           "matmul_ref", "transpose_ref"]
