"""olmoe-1b-7b — MoE, 64 experts top-8, MHA (kv=16).  [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,  # OLMoE uses QK-norm
    rope_theta=10_000.0,
    n_experts=64,
    experts_per_token=8,
    expert_d_ff=1024,
    tie_embeddings=False,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    expert_d_ff=64,
)

register(CONFIG, SMOKE)
