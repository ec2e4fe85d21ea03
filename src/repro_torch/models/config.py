"""Architecture configuration schema for the LM substrate of the port
(a copy of ``repro.models.config``, which the port may not import).

One :class:`ArchConfig` instance fully determines a model: family
(dense / moe / ssm / hybrid / vlm / audio), dimensions, attention flavor
(GQA, RoPE fraction, sliding window, logit softcaps, QKV bias), MoE routing,
and SSM (Mamba-2 SSD) parameters.  ``repro_torch/configs/<id>.py`` holds one
instance per assigned architecture; reduced copies (``smoke()``) drive the
CPU smoke tests.

Dtype policy: params/activations bf16, RMSNorm & softmax statistics f32,
optimizer state f32 (training is not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Per-expert hidden width (== ArchConfig.d_ff for the routed experts).
    d_ff: int
    # Capacity factor for the gather-BMM dispatch; tokens beyond
    # ceil(T*top_k*capacity_factor/E) per expert are dropped (standard TPU
    # MoE practice; tests use a lossless factor).
    capacity_factor: float = 1.25
    # Llama-4 style always-on shared expert (0 = none).
    shared_expert_ff: int = 0
    router_softcap: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer parameters."""
    d_state: int              # N — SSM state size per head
    d_inner: int              # expanded width (usually 2 * d_model)
    head_dim: int = 64        # P — SSD head dim; n_heads = d_inner // P
    n_groups: int = 1         # G — B/C groups
    d_conv: int = 4           # causal depthwise conv width
    chunk: int = 128          # SSD chunk length (perf knob)

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int

    # Attention (unused for family == "ssm").
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_fraction: float = 1.0          # glm4 rotates half the head dim
    window: Optional[int] = None        # sliding-window size (SWA)
    # gemma2: alternate local(window)/global attention; period 2 means
    # layer i uses the window iff i % 2 == 0.
    local_global_period: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)

    # MLP.
    d_ff: int = 0
    mlp_gated: bool = True              # SwiGLU (gated) vs plain GELU

    # Norm/embedding flavor.
    norm_eps: float = 1e-5
    post_norms: bool = False            # gemma2 pre+post sublayer norms
    embed_scale: bool = False           # gemma2 multiplies embeds by sqrt(d)
    tie_embeddings: bool = False

    # Family extensions.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention+MLP block applied before every
    # ``hybrid_period``-th mamba layer.
    hybrid_period: int = 0
    # audio (musicgen): parallel codebook streams; input embeddings are
    # summed, output has n_codebooks heads.  The EnCodec frontend is a stub:
    # input_specs() provides token ids per codebook (embedding lookup is the
    # backbone's own) and examples feed random codes.
    n_codebooks: int = 0
    # vlm (internvl2): the InternViT frontend is a stub; input_specs()
    # provides ``vision_tokens`` precomputed patch embeddings that replace
    # the first V positions (early fusion).
    vision_tokens: int = 0

    # Training-time knobs (per-arch defaults; launcher may override).
    remat: str = "full"                 # full | dots | none
    # Microbatch count for grad accumulation at train_4k on the production
    # mesh (global batch 256); must divide the per-device batch.
    microbatches: int = 1

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def quadratic_attention(self) -> bool:
        """True when some layer attends over the full sequence (=> long_500k
        is skipped for this arch, DESIGN.md §Arch-applicability)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return False   # handled: few attention sites, sequence-sharded
        if self.window is not None and self.local_global_period == 0:
            return False   # pure SWA (mixtral)
        return True

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv, 1)

    def layer_uses_window(self, layer: int) -> bool:
        if self.window is None:
            return False
        if self.local_global_period == 0:
            return True
        return layer % self.local_global_period == 0

    # ---- parameter counting (used by roofline MODEL_FLOPS = 6·N·D) --------

    def param_count(self) -> int:
        """Exact parameter count (embeddings included)."""
        d = self.d_model
        total = self.vocab * d                       # embedding
        if not self.tie_embeddings and self.n_codebooks == 0:
            total += self.vocab * d                  # lm head
        if self.n_codebooks:
            total += (self.n_codebooks - 1) * self.vocab * d   # extra embeds
            total += self.n_codebooks * self.vocab * d         # heads
        total += d                                   # final norm
        per_layer = self._layer_params()
        total += self.n_layers * per_layer
        if self.hybrid_period:
            total += self._shared_block_params()
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        routed_all = 3 * self.d_model * m.d_ff * m.num_experts
        routed_active = 3 * self.d_model * m.d_ff * m.top_k
        return self.param_count() - self.n_layers * (routed_all - routed_active)

    def _attn_params(self, n_heads: int, n_kv: int, head_dim: int) -> int:
        d = self.d_model
        qo = 2 * d * n_heads * head_dim
        kv = 2 * d * n_kv * head_dim
        bias = (n_heads + 2 * n_kv) * head_dim if self.qkv_bias else 0
        return qo + kv + bias

    def _mlp_params(self, d_ff: int) -> int:
        mults = 3 if self.mlp_gated else 2
        return mults * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads)
        return (in_proj + conv_dim * s.d_conv + conv_dim   # conv w + bias
                + 3 * s.n_heads + s.d_inner + s.d_inner * d)

    def _layer_params(self) -> int:
        d = self.d_model
        norms = 2 * d * (2 if self.post_norms else 1)
        if self.family == "ssm" or (self.family == "hybrid"):
            return self._ssm_params() + d            # mamba layer + norm
        attn = self._attn_params(self.n_heads, self.n_kv, self.head_dim)
        if self.moe is not None:
            m = self.moe
            mlp = 3 * d * m.d_ff * m.num_experts + d * m.num_experts
            if m.shared_expert_ff:
                mlp += 3 * d * m.shared_expert_ff
        else:
            mlp = self._mlp_params(self.d_ff)
        return attn + mlp + norms

    def _shared_block_params(self) -> int:
        d = self.d_model
        attn = self._attn_params(self.n_heads, self.n_kv, self.head_dim)
        return attn + self._mlp_params(self.d_ff) + 2 * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The runnable shape cells for an arch (skips recorded in DESIGN.md)."""
    if cfg.quadratic_attention:
        return (TRAIN_4K, PREFILL_32K, DECODE_32K)
    return ALL_SHAPES
