"""internvl2-76b [vlm] — InternViT (stub) + LLaMA3-70B-class backbone.
[arXiv:2404.16821]
Copy of ``repro.configs.internvl2_76b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    act="silu",
    rope_theta=500_000.0,
    frontend="vision",
    frontend_tokens=256,    # image patch tokens after pixel-shuffle
    frontend_dim=3200,      # InternViT-6B hidden size (projected to d_model)
    long_context_ok=False,  # full attention → skip long_500k
)
