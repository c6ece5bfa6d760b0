"""qwen3-1.7b: dense, GQA (kv=8), qk_norm.  The same configuration as
``repro/configs/qwen3_1_7b.py``."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)

register(CONFIG, SMOKE)
