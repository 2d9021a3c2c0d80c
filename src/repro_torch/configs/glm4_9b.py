"""glm4-9b [dense] — GQA kv=2, partial rotary (rotary_frac=0.5), QKV bias.
[hf:THUDM/glm-4-9b]
Copy of ``repro.configs.glm4_9b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    source="hf:THUDM/glm-4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    act="silu",
    qkv_bias=True,
    rope_theta=10_000.0,
    rotary_frac=0.5,
    norm_eps=1.5625e-07,
    serve_window=8192,      # beyond-paper windowed-serving variant
    long_context_ok=True,   # long_500k via the sliding-window serve path
)
