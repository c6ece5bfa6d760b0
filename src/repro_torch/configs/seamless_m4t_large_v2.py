"""seamless-m4t-large-v2: encoder-decoder (family ``audio``), 24 encoder
and 24 decoder layers, 16/16 heads at hd 64, untied vocab of 256,206.  The
speech frontend is a stub, as in JAX: the encoder reads precomputed frame
embeddings ``audio_frames`` (batch, enc_len, d_model) with ``enc_len =
max(int(seq_len * encoder_len_ratio), 16)``.  The same configuration as
``repro/configs/seamless_m4t_large_v2.py``.  Its ``init`` makes
2,034,784,256 values (4.07 GB in bf16); ``param_count``, the reference's
formula, gives 25,600 fewer (2,034,758,656): it counts two norms a decoder
layer where the tree has three, and no ``enc_norm``."""
from repro_torch.configs.base import ModelConfig, reduced, register

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_len_ratio=0.25,
    tie_embeddings=False,
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)

register(CONFIG, SMOKE)
