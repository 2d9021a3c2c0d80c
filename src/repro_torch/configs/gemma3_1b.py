"""gemma3-1b [dense] — 5:1 local:global attention, 512-token window,
qk-norm, tied embeddings, 262k vocab. [hf:google/gemma-3-1b-pt]
Copy of ``repro.configs.gemma3_1b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    act="gelu",
    rope_theta=10_000.0,        # local layers
    rope_theta_global=1_000_000.0,
    sliding_window=512,
    global_every=6,             # every 6th layer global (5:1)
    qk_norm=True,
    norm_offset=1.0,            # rmsnorm weight + 1
    embed_scale=True,
    tie_embeddings=True,
    long_context_ok=True,       # 5:1 SWA; global-layer KV sharded over data
)
