"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]  Copy of ``repro.configs.mamba2_2_7b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,                 # no separate MLP block (mamba block only)
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,        # 2*2560/64 = 80 SSD heads
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    norm_eps=1e-5,
    tie_embeddings=True,
    use_ssd_kernel=True,
    long_context_ok=True,   # O(1) state → long_500k runs
)
