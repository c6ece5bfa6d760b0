"""qwen3-32b — dense, GQA (kv=8), qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
)

register(CONFIG, SMOKE)
