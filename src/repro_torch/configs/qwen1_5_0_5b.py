"""qwen1.5-0.5b [dense] — GQA kv=16 (MHA), QKV bias. [hf:Qwen/Qwen1.5-0.5B]
Copy of ``repro.configs.qwen1_5_0_5b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    serve_window=8192,      # beyond-paper windowed-serving variant
    long_context_ok=True,   # long_500k via the sliding-window serve path
)
