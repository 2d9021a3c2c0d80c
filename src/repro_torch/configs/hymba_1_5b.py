"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer,
meta tokens, mostly-SWA attention. [arXiv:2411.13676]
Copy of ``repro.configs.hymba_1_5b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    act="silu",
    rope_theta=10_000.0,
    sliding_window=1024,
    global_every=16,        # layers 16, 32 global (plus layer 1 in the paper)
    hybrid=True,
    n_meta_tokens=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,        # 2*1600/64 = 50 SSD heads
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    long_context_ok=True,   # SSM + SWA → long_500k runs
)
