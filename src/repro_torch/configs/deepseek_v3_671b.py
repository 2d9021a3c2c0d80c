"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 (sigmoid
router, aux-free), MTP. [arXiv:2412.19437]
Copy of ``repro.configs.deepseek_v3_671b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,         # MLA: all heads share the compressed KV
    d_ff=18432,             # dense-layer FFN (first_k_dense layers)
    vocab=129280,
    act="silu",
    rope_theta=10_000.0,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    router="sigmoid",
    routed_scaling=2.5,
    first_k_dense=3,
    mtp_depth=1,
    capacity_factor=1.25,
    moe_impl="ep",          # shard_map expert-parallel dispatch (§Perf iter 2)
    long_context_ok=True,   # MLA compressed KV keeps the 500k cache small
)
