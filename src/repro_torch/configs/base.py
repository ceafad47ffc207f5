"""Configuration dataclasses for the repro framework.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; shapes are the four assigned (seq_len, global_batch) cells.
Configs are plain frozen dataclasses so they hash/compare cleanly and can be
reduced (``reduced()``) for CPU smoke tests.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    shared_experts: int = 0        # always-on experts (Moonlight style)
    dense_residual: bool = False   # parallel dense FFN (Arctic style)
    dense_d_ff: int = 0            # hidden of the dense residual FFN
    router_noise: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256               # SSD chunk length (MXU-friendly)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid: pattern of block kinds, repeated."""
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "local_attn")
    lru_width: int = 0             # 0 => d_model
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 => d_model // n_heads
    ffn_act: str = "swiglu"        # swiglu | geglu | gelu | relu2
    use_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10000.0
    attn_kind: str = "full"        # full | swa | none
    window: int = 0                # sliding/local attention window (0 = none)
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # MoE / SSM / hybrid extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # VLM: a cross-attention layer is inserted after every `cross_attn_every`
    # self-attention layers. n_layers counts self+cross together.
    cross_attn_every: int = 0
    n_img_tokens: int = 1024
    # enc-dec (audio): encoder depth; n_layers is the decoder depth.
    encoder_layers: int = 0
    n_frames: int = 3072           # stub audio frontend output length
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    # provenance
    source: str = ""

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with O(1)/O(window) state?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_kind == "swa" and self.window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    @property
    def n_attention_layers(self) -> int:
        """Layers with attention: none of an SSM's, a hybrid's layers whose
        kind in its repeated pattern is not ``recurrent``, every layer
        otherwise."""
        if self.family == "ssm":
            return 0
        if self.family != "hybrid":
            return self.n_layers
        pat = self.hybrid.pattern
        return sum(pat[i % len(pat)] != "recurrent"
                   for i in range(self.n_layers))

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim
        p = self.padded_vocab * d                       # embed
        if not self.tie_embeddings:
            p += self.padded_vocab * d                  # lm head
        def attn_params() -> int:
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        def ffn_params(hidden: int, gated: bool) -> int:
            return d * hidden * (3 if gated else 2)
        gated = self.ffn_act in ("swiglu", "geglu")
        layers = 0
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            layers = self.n_layers * (in_proj + di * d + di * s.conv_kernel
                                      + 2 * nh + 2 * d)
        elif self.family == "hybrid":
            h = self.hybrid
            w = h.lru_width or d
            rec = d * w * 2 + w * d + w * h.conv_kernel + 4 * w  # proj+gates+conv
            att = attn_params()
            n_att = self.n_attention_layers
            n_rec = self.n_layers - n_att
            layers = n_rec * rec + n_att * att \
                + self.n_layers * (ffn_params(self.d_ff, gated) + 2 * d)
        else:
            per = attn_params() + 2 * d
            if self.moe is not None:
                m = self.moe
                per += d * m.n_experts                       # router
                per += m.n_experts * ffn_params(m.d_expert, gated) // 1
                per += m.shared_experts * ffn_params(m.d_expert, gated)
                if m.dense_residual:
                    per += ffn_params(m.dense_d_ff or self.d_ff, gated)
            else:
                per += ffn_params(self.d_ff, gated)
            n_self = self.n_layers
            if self.cross_attn_every:
                n_cross = self.n_layers // (self.cross_attn_every + 1)
                n_self = self.n_layers - n_cross
                layers = n_self * per + n_cross * (attn_params() + 2 * d +
                                                   ffn_params(self.d_ff, gated))
            else:
                layers = n_self * per
            if self.encoder_layers:
                # encoder self-attn + FFN, decoder adds cross-attn per layer
                layers += self.encoder_layers * per
                layers += self.n_layers * attn_params()
        return p + layers

    def active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        gated = self.ffn_act in ("swiglu", "geglu")
        per_expert = self.d_model * m.d_expert * (3 if gated else 2)
        inactive = self.n_layers * (m.n_experts - m.top_k) * per_expert
        return self.n_params() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.cross_attn_every else 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=32,
            d_ff=256,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            n_img_tokens=16,
            n_frames=32,
            encoder_layers=min(self.encoder_layers, 2),
            vocab_pad_multiple=16,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe is not None:
            # generous capacity so reduced-scale tests are drop-free (drops
            # make prefill/decode routing legitimately diverge)
            kw["moe"] = replace(self.moe, n_experts=4, top_k=2, d_expert=64,
                                capacity_factor=8.0,
                                dense_d_ff=64 if self.moe.dense_residual
                                else 0)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, headdim=32, chunk=16)
        if self.hybrid is not None:
            kw["hybrid"] = replace(self.hybrid, lru_width=128, conv_kernel=4)
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shape cells.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    microbatches: int = 1
    master_dtype: str = "float32"   # optimizer moment / master-param dtype
    use_master_copy: bool = False   # fp32 master params (off: update in-place)
    zero_sharded_opt: bool = True   # shard optimizer state like params
