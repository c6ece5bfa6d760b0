"""recurrentgemma-2b: hybrid, RG-LRU recurrent blocks and local attention in
the pattern (rec, rec, attn), head dim 256 over one KV head, 2048-key
windows, scaled embeddings.  The same configuration as
``repro/configs/recurrentgemma_2b.py``."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10_000.0,
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
    scale_embeddings=True,
)

SMOKE = reduced(
    CONFIG,
    n_layers=3,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    lru_width=64,
)

register(CONFIG, SMOKE)
