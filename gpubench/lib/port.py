"""The program under test as the benchmark drives it: the only module of
the benchmark that imports ``repro_torch``.

- ``port_config`` maps a configuration file onto the program's registry
  entry (``repro_arch``) and, for a benchmark run, refuses a file whose
  sizes differ from it or from the program's fixed choices (the norm's
  epsilon, the MoE's group of tokens).
- ``build_engine`` builds ``InferenceEngine`` around weights that the
  benchmark drew (``lib.weights``) and wrote into the model's parameters
  by name: the engine's own draw is replaced by them, so the weights are
  made once.
- ``Capture`` keeps what the engine's bucket function produced inside
  the timed call: the last position's logits of ``forward``, the
  prefill's and each decode step's logits of ``generate`` (references,
  or the one row's copy where the call's logits hold every position).
- ``Ranges`` puts profiler ranges around the model's MoE layer and its
  two attention kernels' entries, from outside (the module attributes
  that ``models.transformer`` and ``models.attention`` call), and logs
  each attention call's shapes while a trace is recorded.
- ``policy`` gives the program's batching policy a traffic file names.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional

import torch
from torch.profiler import record_function

MOE_RANGE = "gpubench.moe"
ATTN_RANGE = "gpubench.attn"
MLA_RANGE = "gpubench.mla_decode"


def port_config(cfg: dict, *, strict: bool = True):
    """The program's ``ModelConfig`` for a configuration file.  With
    ``strict`` it must equal the registry's entry itself."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    from repro_torch.models import layers, moe

    base = get_config(cfg["repro_arch"])
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kw = dict(num_layers=cfg["num_hidden_layers"], d_model=d, num_heads=h,
              num_kv_heads=cfg["num_key_value_heads"],
              vocab_size=cfg["vocab_size"],
              d_ff=cfg["intermediate_size"],
              rope_theta=float(cfg["rope_theta"]),
              max_position_embeddings=cfg["max_position_embeddings"],
              tie_embeddings=cfg["tie_word_embeddings"],
              dtype=cfg["torch_dtype"])
    if "kv_lora_rank" in cfg:
        kw["head_dim"] = 0
        kw["mla"] = MLAConfig(
            kv_lora_rank=cfg["kv_lora_rank"],
            q_lora_rank=cfg["q_lora_rank"] or 0,
            qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"])
    else:
        kw["head_dim"] = d // h
        kw["partial_rotary_factor"] = float(cfg["partial_rotary_factor"])
    if "n_routed_experts" in cfg:
        kw["moe"] = dataclasses.replace(
            base.moe, num_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            d_expert=cfg["moe_intermediate_size"],
            num_shared_experts=cfg["n_shared_experts"],
            d_shared=cfg["moe_intermediate_size"],
            first_dense=cfg["first_k_dense_replace"],
            moe_layer_period=cfg["moe_layer_freq"],
            capacity_factor=float(cfg["moe_capacity_factor"]))
        if moe.DEFAULT_GROUP != cfg["moe_group_tokens"]:
            raise ValueError(f"the program routes groups of "
                             f"{moe.DEFAULT_GROUP} tokens, the configuration "
                             f"states {cfg['moe_group_tokens']}")
    scaling = cfg.get("rope_scaling")
    if scaling is not None and not (scaling.get("type") == "yarn"
                                    and float(scaling["factor"]) == 1.0):
        raise ValueError(f"the program rotates with plain RoPE frequencies, "
                         f"the configuration states rope_scaling {scaling}")
    eps = inspect.signature(layers.apply_norm).parameters["eps"].default
    if eps != float(cfg["rms_norm_eps"]):
        raise ValueError(f"the program's RMSNorm epsilon is {eps}, the "
                         f"configuration states {cfg['rms_norm_eps']}")
    pcfg = dataclasses.replace(base, **kw)
    if strict and pcfg != base:
        diff = [f.name for f in dataclasses.fields(base)
                if getattr(base, f.name) != getattr(pcfg, f.name)]
        raise ValueError(f"{cfg['repro_arch']}: the configuration file "
                         f"differs from the program's registry in {diff}")
    return pcfg


def build_engine(pcfg, weights, *, workload: str, seq_len: int,
                 gen_tokens: int, b_max: int, device):
    """``InferenceEngine`` over the benchmark's weights (``weights.fill``
    into the model's parameters, made empty on ``device``)."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.models import transformer

    params = transformer.abstract_params(pcfg).to_empty(device=device)
    weights.fill(params)
    real = engine_mod.build

    def build(cfg):
        return dataclasses.replace(real(cfg), init=lambda gen: params)

    engine_mod.build = build
    try:
        return engine_mod.InferenceEngine(
            pcfg, workload=workload, seq_len=seq_len, gen_tokens=gen_tokens,
            max_batch=b_max, seed=0, device=device)
    finally:
        engine_mod.build = real


class Capture:
    """Wraps the engine's bundle functions, which its bucket function
    looks up at each call, and keeps each call's logits in ``logits`` (a
    list a batch, cleared by ``begin``).  ``position`` is the cache
    position the current decode step writes (the prompt's length plus the
    steps before it)."""

    def __init__(self, engine, seq_len: int):
        bundle = engine.bundle
        self.seq_len = seq_len
        self.position = seq_len
        self.logits: List[torch.Tensor] = []
        self._forward = bundle.forward
        self._prefill = bundle.prefill
        self._decode = bundle.decode_step
        object.__setattr__(bundle, "forward", self.forward)
        object.__setattr__(bundle, "prefill", self.prefill)
        object.__setattr__(bundle, "decode_step", self.decode_step)

    def begin(self) -> None:
        self.logits = []

    def forward(self, params, batch, **kw):
        logits, aux = self._forward(params, batch, **kw)
        self.logits.append(logits[:, -1].clone())
        return logits, aux

    def prefill(self, params, batch, cache_len, **kw):
        logits, cache = self._prefill(params, batch, cache_len, **kw)
        self.logits.append(logits[:, -1])
        self.position = self.seq_len
        return logits, cache

    def decode_step(self, params, tokens, cache, lengths, **kw):
        logits, cache = self._decode(params, tokens, cache, lengths, **kw)
        self.logits.append(logits[:, -1])
        self.position += 1
        return logits, cache


class Ranges:
    """Profiler ranges around ``apply_moe``, ``flash_attention`` and
    ``mla_decode_attention`` as the model calls them.  While ``logging``,
    each attention call appends its shapes to ``calls``: ``("attn", q, k,
    v shapes, element bytes, causal, window)`` and ``("mla", (B, H, R),
    rope width, cache shape, cache element bytes, admitted positions)``."""

    def __init__(self, capture: Optional[Capture] = None):
        from repro_torch.models import attention, transformer

        self.calls: list = []
        self.logging = False
        self._mods = (transformer, attention)
        self._real = (transformer.apply_moe, attention.flash_attention,
                      attention.mla_decode_attention)
        moe_fn, flash, mla = self._real

        def apply_moe(*a, **kw):
            with record_function(MOE_RANGE):
                return moe_fn(*a, **kw)

        def flash_attention(q, k, v, **kw):
            if self.logging:
                self.calls.append(("attn", tuple(q.shape), tuple(k.shape),
                                   tuple(v.shape), q.element_size(),
                                   kw.get("causal", True),
                                   kw.get("window", 0)))
            with record_function(ATTN_RANGE):
                return flash(q, k, v, **kw)

        def mla_decode_attention(q_abs, q_pe, c_kv, k_pe, lengths, **kw):
            if self.logging:
                pos = capture.position if capture is not None else c_kv.shape[1] - 1
                self.calls.append(("mla", tuple(q_abs.shape), q_pe.shape[-1],
                                   tuple(c_kv.shape), c_kv.element_size(),
                                   pos + 1))
            with record_function(MLA_RANGE):
                return mla(q_abs, q_pe, c_kv, k_pe, lengths, **kw)

        transformer.apply_moe = apply_moe
        attention.flash_attention = flash_attention
        attention.mla_decode_attention = mla_decode_attention

    def remove(self) -> None:
        transformer, attention = self._mods
        (transformer.apply_moe, attention.flash_attention,
         attention.mla_decode_attention) = self._real


def policy(name: str, b_max: int):
    """The batching policy a traffic file names: ``capped`` is the paper's
    batch-all-waiting (Eq. 2) with at most ``b_max`` requests a batch,
    the program's ``CappedBatch``."""
    from repro_torch.core.policy import CappedBatch

    if name != "capped":
        raise ValueError(f"unknown policy {name!r}")
    return CappedBatch(cap=b_max)


def bucket_call(engine, bb: int) -> Callable:
    """The engine's bucket function for ``bb`` rows: the call that
    ``InferenceEngine.run_batch`` times."""
    return engine._fns[bb]
