"""Configuration dataclasses and the architecture registry.

Every assigned architecture gets one module in this package defining a
``CONFIG`` (exact published dimensions, source cited in the module docstring)
and registering itself.  ``reduced(cfg)`` derives the CPU-smoke variant
(2 layers, d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden width of each routed expert
    num_shared_experts: int = 0        # DeepSeek-style always-on experts
    d_shared: int = 0                  # hidden width of the shared expert(s)
    router_aux_weight: float = 0.01    # load-balance loss weight
    moe_layer_period: int = 1          # MoE every k-th layer (Jamba: 2)
    first_dense: int = 0               # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25      # expert capacity slack (GShard)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD state-space block configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention configuration."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 => project q directly (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) and the stub frontends.

    For ``audio``: the conv feature extractor is a STUB — ``input_specs``
    provides pre-computed frame embeddings ``(B, n_ctx, d_model)``.
    For ``vlm``: the ViT is a STUB — ``input_specs`` provides patch embeddings
    ``(B, n_ctx, d_model)`` already projected into the LM width.
    """

    num_layers: int = 0                # 0 => pure stub (VLM projector only)
    n_ctx: int = 1500                  # number of frames / patches
    d_model: int = 0                   # 0 => same as decoder d_model
    num_heads: int = 0
    d_ff: int = 0


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # one of FAMILIES
    source: str                        # citation for the exact numbers

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    qkv_bias: bool = False
    qk_norm: bool = False              # OLMoE-style q/k RMSNorm
    activation: str = "swiglu"         # 'swiglu' | 'gelu'
    norm: str = "rmsnorm"              # 'rmsnorm' | 'layernorm'
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    max_position_embeddings: int = 32768
    tie_embeddings: bool = False
    learned_positions: bool = False    # whisper-style absolute positions

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None

    # hybrid interleave: attention layer every `attn_layer_period` layers,
    # offset `attn_layer_offset`; all other layers are SSM blocks.
    attn_layer_period: int = 0         # 0 => all-attention (or all-SSM)
    attn_layer_offset: int = 0

    # long-context serving variant: sliding-window width used for the
    # `long_500k` shape on attention archs (0 => full attention only).
    sliding_window: int = 8192

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def layer_kinds(self) -> List[str]:
        """Per-layer block kind: 'attn' or 'ssm'."""
        if self.family == "ssm":
            return ["ssm"] * self.num_layers
        if self.attn_layer_period:
            return [
                "attn"
                if (i % self.attn_layer_period) == self.attn_layer_offset
                else "ssm"
                for i in range(self.num_layers)
            ]
        return ["attn"] * self.num_layers

    def moe_layers(self) -> List[bool]:
        """Per-layer flag: does this layer use the MoE FFN?"""
        if self.moe is None:
            return [False] * self.num_layers
        return [
            i >= self.moe.first_dense and (i % self.moe.moe_layer_period
                                           == self.moe.moe_layer_period - 1
                                           if self.moe.moe_layer_period > 1
                                           else True)
            for i in range(self.num_layers)
        ]

    def has_attention(self) -> bool:
        return any(k == "attn" for k in self.layer_kinds())

    # --- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------
    def param_counts(self) -> Dict[str, float]:
        """Return {'total': N, 'active': N_active} parameter counts."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = float(emb)
        active = float(emb)
        kinds = self.layer_kinds()
        moe_flags = self.moe_layers()
        for i in range(L):
            if kinds[i] == "ssm":
                s = self.ssm or SSMConfig()
                d_in = s.d_inner(d)
                nh = s.n_heads(d)
                # in_proj: z, x, B, C, dt ; out_proj
                blk = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                blk += d_in * d
                blk += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                blk += 3 * nh  # A, D, dt_bias
                total += blk
                active += blk
            else:
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    a = d * self.num_heads * qd          # q proj
                    a += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    a += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    a += self.num_heads * m.v_head_dim * d
                else:
                    hd = self.head_dim
                    a = d * (self.num_heads + 2 * self.num_kv_heads) * hd
                    a += self.num_heads * hd * d
                total += a
                active += a
            # FFN
            mult = 3 if self.activation == "swiglu" else 2
            if moe_flags[i]:
                mo = self.moe
                routed = mo.num_experts * mult * d * mo.d_expert
                shared = mo.num_shared_experts * mult * d * mo.d_shared
                router = d * mo.num_experts
                total += routed + shared + router
                active += (mo.top_k * mult * d * mo.d_expert
                           + shared + router)
            elif self.d_ff:
                total += mult * d * self.d_ff
                active += mult * d * self.d_ff
        if self.encoder is not None and self.encoder.num_layers:
            e = self.encoder
            ed = e.d_model or d
            per = 4 * ed * ed + 2 * ed * (e.d_ff or 4 * ed)
            total += e.num_layers * per
            active += e.num_layers * per
        return {"total": total, "active": active}


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_MODULES = [
    "qwen1_5_4b",
    "codeqwen1_5_7b",
    "whisper_medium",
    "internvl2_1b",
    "olmoe_1b_7b",
    "jamba_v0_1_52b",
    "mamba2_2_7b",
    "deepseek_v2_lite_16b",
    "qwen1_5_0_5b",
    "phi4_mini_3_8b",
]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    key = name.replace("-", "_").replace(".", "_")
    for cand in (name, key):
        if cand in _REGISTRY:
            return _REGISTRY[cand]
    raise KeyError(f"unknown architecture {name!r}; have {sorted(_REGISTRY)}")


def list_archs() -> List[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


# ---------------------------------------------------------------------------
# Reduced (smoke) variants
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=512, <=4
    experts, small vocab.  Keeps the family-defining structure (GQA ratio,
    MoE routing, SSD scan, hybrid interleave, MLA latent path)."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(cfg.num_heads, d_model // head_dim))
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads)) \
        if cfg.num_kv_heads else 1
    num_kv = max(1, num_heads // ratio)
    kw: Dict = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_position_embeddings=4096,
        sliding_window=64,
    )
    if cfg.moe is not None:
        ne = min(cfg.moe.num_experts, 4)
        tk = min(cfg.moe.top_k, 2)
        kw["moe"] = replace(
            cfg.moe,
            num_experts=ne,
            top_k=tk,
            d_expert=min(cfg.moe.d_expert, 128),
            d_shared=min(cfg.moe.d_shared, 128) if cfg.moe.d_shared else 0,
            first_dense=min(cfg.moe.first_dense, 1),
            capacity_factor=float(ne) / tk,   # no token drops in smoke tests
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=32, chunk_size=32)
    if cfg.mla is not None:
        kw["mla"] = replace(
            cfg.mla, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
    if cfg.encoder is not None:
        kw["encoder"] = replace(
            cfg.encoder,
            num_layers=min(cfg.encoder.num_layers, 2),
            n_ctx=32,
            d_model=d_model if cfg.encoder.d_model else 0,
            num_heads=num_heads if cfg.encoder.num_heads else 0,
            d_ff=min(cfg.encoder.d_ff, 512) if cfg.encoder.d_ff else 0,
        )
    if cfg.attn_layer_period:
        kw["attn_layer_period"] = 2
        kw["attn_layer_offset"] = 1
    return replace(cfg, name=cfg.name + "-reduced", dtype="float32", **kw)
