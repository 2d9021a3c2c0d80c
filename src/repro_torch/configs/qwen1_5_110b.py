"""qwen1.5-110b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen1.5-0.5B]
Copy of ``repro.configs.qwen1_5_110b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B (110B sibling)",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_ok=False,  # full attention, no windowed variant → skip long_500k
)
