"""mamba2-370m: attention-free SSM with SSD (state-space duality), 48
layers, state 128, chunks of 256.  The same configuration as
``repro/configs/mamba2_370m.py``."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
)

register(CONFIG, SMOKE)
