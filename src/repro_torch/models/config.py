"""Model configuration: one dataclass covers all 10 assigned architectures.

A copy of the JAX package's ``models/config.py``; ``torch_dtype`` maps the
``dtype`` field to the tensor type.  The port runs the ``dense`` and
``ssm`` families (``repro_torch.models.registry``); the other fields are
carried so that a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention options
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen1.5 / qwen2 family
    rope_theta: float = 10_000.0
    mrope: bool = False  # qwen2-vl 3-axis multimodal RoPE
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # hybrid (zamba2): shared attention block applied every `attn_every`
    # mamba layers (weights shared across applications)
    attn_every: int = 0

    # encoder-decoder (whisper)
    num_encoder_layers: int = 0

    # modality frontend: "tokens" (LM) | "embeddings" (audio/vlm stubs)
    input_mode: str = "tokens"

    # MLP
    mlp_variant: str = "swiglu"  # swiglu (3-matrix) | gelu (2-matrix)

    # numerics / perf knobs
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | none
    optimizer: str = "adamw"  # adamw | adafactor
    attn_impl: str = "chunked"  # chunked | naive | pallas
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    causal_block_skip: bool = False  # perf: skip fully-masked KV blocks
    scan_layers: bool = True
    logits_softcap: float = 0.0

    # sharding knobs (hillclimb targets)
    shard_kv_seq: bool = False  # shard decode KV cache along sequence
    zero1_optimizer_sharding: bool = True  # shard opt state over data axis
    fsdp: bool = False  # additionally shard params over the data axis (ZeRO-3)
    train_accum: int = 1  # microbatch gradient-accumulation steps
    grad_accum_dtype: str = "float32"  # float32 | bfloat16 accumulator

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6·N·D bookkeeping."""
        d, hd = self.d_model, self.resolved_head_dim
        mlp_mats = 3 if self.mlp_variant == "swiglu" else 2
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings and self.input_mode == "tokens":
            n += self.vocab_size * d  # lm head
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            attn = q + kv + o
            per_layer += attn
            if self.family == "moe":
                per_layer += 3 * d * self.moe_d_ff * self.num_experts
                per_layer += 3 * d * self.moe_d_ff * self.num_shared_experts
                per_layer += d * self.num_experts  # router
                if self.dense_residual:
                    per_layer += mlp_mats * d * self.d_ff
            else:
                per_layer += mlp_mats * d * self.d_ff
        elif self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            proj_in = d * (2 * di + 2 * ns + nh)
            proj_out = di * d
            per_layer += proj_in + proj_out + (di + 2 * ns) * self.ssm_conv_width
        n += per_layer * self.num_layers
        if self.family == "hybrid" and self.attn_every:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            n += q + kv + o + 3 * d * self.d_ff  # one shared block
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            enc = (d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
                   + 3 * d * self.d_ff)
            n += enc * self.num_encoder_layers
            n += (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                  + self.num_heads * hd * d) * self.num_layers  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts only routed top-k experts."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dead = 3 * d * self.moe_d_ff * (
            self.num_experts - self.num_experts_per_tok
        ) * self.num_layers
        return self.param_count() - dead


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) dry-run cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
