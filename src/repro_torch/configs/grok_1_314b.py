"""grok-1-314b [moe] — 8 experts top-2, attention logit softcap.
[hf:xai-org/grok-1]
Copy of ``repro.configs.grok_1_314b``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    act="silu",   # gated expert FFN (3 matrices, grok-1 linear_v/linear_1/linear)
    rope_theta=10_000.0,
    attn_softcap=30.0,
    attn_output_multiplier=0.08838834764831845,
    n_experts=8,
    top_k=2,
    d_ff_expert=32768,
    router="softmax",
    capacity_factor=1.25,
    moe_impl="ep",          # virtual-expert shard_map dispatch (§Perf iter 3)
    long_context_ok=False,  # full attention → skip long_500k
)
