"""whisper-large-v3 [audio] — enc-dec transformer backbone, conv frontend
stubbed (input_specs supplies 1500 post-conv frame embeddings).
[arXiv:2212.04356]
Copy of ``repro.configs.whisper_large_v3``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="encdec",
    source="arXiv:2212.04356",
    n_layers=32,            # decoder layers
    n_enc_layers=32,        # encoder layers
    enc_dec=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,          # MHA
    d_ff=5120,
    vocab=51866,
    act="gelu",
    qkv_bias=True,          # whisper uses biases (no bias on k proj; modeled uniformly)
    pos_embedding="sinusoidal",
    rope_theta=0.0,
    frontend="audio",
    frontend_tokens=1500,   # 30 s of audio after the conv stack
    frontend_dim=1280,      # stub supplies post-conv d_model embeddings
    norm_eps=1e-5,
    tie_embeddings=True,
    long_context_ok=False,  # 448-token decoder spec; long_500k skipped (DESIGN §5)
)
