"""llama-3.2-vision-90b: VLM (family ``vlm``), 100 layers in 20 superblocks
of four self-attention layers and one gated cross-attention layer over 1601
image tokens, 64/8 heads at hd 128, untied vocab of 128,256.  The vision
frontend is a stub, as in JAX: the model reads precomputed patch embeddings
``image_embeds`` (batch, n_image_tokens, d_model).  The same configuration
as ``repro/configs/llama_3_2_vision_90b.py``.

``param_count`` is the reference's formula, 90,687,021,056: it counts 100
full layers and then one more attention block and two norms per cross
layer (``cross_attn_every`` divides ``n_layers``).  The tree that ``init``
makes holds 87,666,799,656 values: 80 self layers and 20 cross layers, each
cross layer one attention block, one MLP, two norms, two scalar gates and
the per-head ``q_norm`` / ``k_norm``.  The 3.02e9 between them is the
formula's, kept as the reference computes it."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1601,  # 1 tile x (40x40 patches + 1 cls)
    tie_embeddings=False,
)

SMOKE = reduced(
    CONFIG,
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=5,
    n_image_tokens=17,
)

register(CONFIG, SMOKE)
