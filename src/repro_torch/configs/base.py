"""Model configuration: the port's copy of ``repro.configs.base``.

``ModelConfig``, ``ShapeConfig``, ``SHAPES`` and ``smoke()`` are copied
field for field, with the same defaults, so a config built here equals
the reference's (``tests/test_torch_serve.py`` compares them).  The
port imports nothing of ``repro``, so it keeps this copy.

The port runs every architecture of ``ARCH_IDS`` (:data:`PORTED`):
``mamba2-2.7b``, the dense family (``gemma3-1b``, ``qwen1.5-0.5b``,
``glm4-9b``, ``qwen1.5-110b``), the MoE family (``deepseek-v3-671b``,
``grok-1-314b``), the hybrid ``hymba-1.5b``, the encoder-decoder
``whisper-large-v3`` and the vision-language ``internvl2-76b``;
:func:`get_config` raises ``NotImplementedError`` for an id of
``ARCH_IDS`` outside it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    arch_type: str = "dense"     # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""             # paper / model-card citation

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000
    act: str = "silu"            # silu (swiglu) | gelu (plain 2-mat mlp)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm_offset: float = 0.0     # gemma: weight + 1
    embed_scale: bool = False    # gemma: x * sqrt(d_model)
    qk_norm: bool = False

    # rope / attention
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # gemma3: separate theta for global layers
    rotary_frac: float = 1.0         # glm4 uses 0.5
    sliding_window: int = 0          # 0 → full attention
    global_every: int = 0            # gemma3: every Nth layer is global (1-based)
    attn_softcap: float = 0.0        # grok-style tanh cap; 0 → off
    attn_output_multiplier: float = 0.0  # grok; 0 → default 1/sqrt(head_dim)

    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router: str = "softmax"      # softmax | sigmoid (deepseek v3)
    routed_scaling: float = 1.0
    first_k_dense: int = 0       # deepseek: first k layers stay dense
    capacity_factor: float = 1.25
    mtp_depth: int = 0           # deepseek multi-token prediction heads
    moe_impl: str = "gather"     # gather (auto-partitioned) | ep (shard_map
                                 # expert-parallel; falls back if indivisible)

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (hymba)
    hybrid: bool = False         # parallel attn + ssm heads per layer
    n_meta_tokens: int = 0

    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    pos_embedding: str = "rope"  # rope | sinusoidal | learned

    # modality frontend (stub — embeddings supplied by input_specs)
    frontend: str = "none"       # none | audio | vision
    frontend_tokens: int = 0     # frames / patches per sample
    frontend_dim: int = 0        # raw frontend embedding dim (projected)

    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"         # none | block (checkpoint each layer block)
    scan_layers: bool = True
    use_flash_kernel: bool = False  # Pallas attention in prefill path
    use_ssd_kernel: bool = False    # Pallas SSD in ssm fwd path

    # long-context serving: archs that can run long_500k
    long_context_ok: bool = False
    serve_window: int = 0        # beyond-paper windowed-serving variant

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.first_k_dense

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, max(1, min(self.n_heads, 4) // 2)),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            d_ff_expert=min(self.d_ff_expert, 256) if self.d_ff_expert else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            global_every=self.global_every,
            mtp_depth=min(self.mtp_depth, 1),
            dtype="float32",
            param_dtype="float32",
            remat="none",
            scan_layers=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "whisper-large-v3",
    "qwen1.5-110b",
    "qwen1.5-0.5b",
    "internvl2-76b",
    "deepseek-v3-671b",
    "mamba2-2.7b",
    "grok-1-314b",
    "glm4-9b",
    "hymba-1.5b",
    "gemma3-1b",
)

#: architectures the port runs
PORTED = ("mamba2-2.7b", "gemma3-1b", "qwen1.5-0.5b", "glm4-9b", "qwen1.5-110b",
          "hymba-1.5b", "whisper-large-v3", "internvl2-76b", "deepseek-v3-671b",
          "grok-1-314b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(ARCH_IDS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet (see ROADMAP.md); "
            f"ported: {list(PORTED)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
