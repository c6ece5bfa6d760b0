"""gemma3-1b: dense, GQA (kv=1), head dim 256, 5:1 local:global sliding
window, scaled embeddings.  The same configuration as
``repro/configs/gemma3_1b.py``."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    rope_theta=1_000_000.0,
    sliding_window=512,
    global_every=6,  # layers 5, 11, 17, 23 are global -> 5:1 local:global
    tie_embeddings=True,
    scale_embeddings=True,
)

SMOKE = reduced(
    CONFIG,
    n_layers=6,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    global_every=3,
)

register(CONFIG, SMOKE)
