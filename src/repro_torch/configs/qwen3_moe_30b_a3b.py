"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, GQA (kv=4).
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
    expert_d_ff=768,
    tie_embeddings=False,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    expert_d_ff=64,
)

register(CONFIG, SMOKE)
