"""Operations and bytes, counted from shapes: the model's work a request
needs (``request_flops``) and the least time of the attention kernels'
calls (``flash_bound_s``, ``mla_decode_bound_s``).

A multiply-add is two operations.  A request's work counts every layer
over its real prompt tokens: the projections, causal attention's
admitted (query, key) pairs, the FFN (a MoE layer: the router, its top-k
routed experts and the shared ones), the unembedding of the positions
whose logits are served (the prompt's last, then each decode step's),
and each decode step through every layer (MLA decode in the absorbed
form the program computes).  It leaves out the rows that pad a batch,
the logits of the prompt's other positions, the expert slots that hold
no token, the norms and the embedding gather.
"""
from __future__ import annotations

from gpubench.lib.peaks import least_seconds


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal head admits over ``s`` positions."""
    return s * (s + 1) // 2


def _per_token_layer(cfg: dict, moe_layer: bool) -> float:
    """Projections and FFN of one token through one layer."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if "kv_lora_rank" in cfg:
        nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
        attn = (d * h * (nope + rp) + d * r + d * rp
                + r * h * (nope + vd) + h * vd * d)
    else:
        hd = d // h
        kv = cfg["num_key_value_heads"]
        attn = d * (h + 2 * kv) * hd + h * hd * d
    if moe_layer:
        f = cfg["moe_intermediate_size"]
        ffn = (d * cfg["n_routed_experts"]
               + 3 * d * f * (cfg["num_experts_per_tok"]
                              + cfg["n_shared_experts"]))
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return 2.0 * (attn + ffn)


def _attn_pair(cfg: dict, decode: bool) -> float:
    """Operations of one head and one admitted (query, key) pair."""
    if "kv_lora_rank" in cfg:
        r, rp = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        if decode:     # scores against [c_kv ‖ k_pe], context over c_kv
            return 2.0 * (2 * r + rp)
        return 2.0 * (cfg["qk_nope_head_dim"] + rp + cfg["v_head_dim"])
    return 4.0 * (cfg["hidden_size"] // cfg["num_attention_heads"])


def moe_layers(cfg: dict) -> list:
    n = cfg["num_hidden_layers"]
    if "n_routed_experts" not in cfg:
        return [False] * n
    return [i >= cfg["first_k_dense_replace"] for i in range(n)]


def request_flops(cfg: dict, prompt_len: int, gen_tokens: int = 0) -> float:
    """Operations one request needs: its prompt, then ``gen_tokens``
    decode steps."""
    layers = moe_layers(cfg)
    h = cfg["num_attention_heads"]
    unembed = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    total = unembed * (1 + gen_tokens)
    for moe in layers:
        total += prompt_len * _per_token_layer(cfg, moe)
        total += h * causal_pairs(prompt_len) * _attn_pair(cfg, False)
        for t in range(gen_tokens):
            keys = prompt_len + t + 1
            total += _per_token_layer(cfg, moe)
            total += h * keys * _attn_pair(cfg, True)
    return total


def flash_bound_s(q, k, v, elt: int, causal: bool, window: int) -> float:
    """B3's least time on shapes q ``(B, S, H, hd)``, k ``(B, S_k, KV,
    hd)``, v ``(B, S_k, KV, hdv)``: q, k, v read once and the output
    written once; ``2 (hd + hdv)`` operations a head and admitted pair."""
    b, s, h, hd = q
    sk, hdv = k[1], v[3]
    if causal:
        if window and window < s:
            pairs = window * (window + 1) // 2 + (s - window) * window
        else:
            pairs = causal_pairs(s)
    else:
        pairs = s * sk if not window else sum(
            sk - min(sk, max(0, i - window + 1)) for i in range(s))
    flops = 2.0 * (hd + hdv) * b * h * pairs
    nbytes = elt * (b * s * h * hd + b * sk * k[2] * hd + b * sk * v[2] * hdv
                    + b * s * h * hdv)
    return least_seconds(flops, nbytes)


def mla_decode_bound_s(q_abs, rope: int, cache, elt: int,
                       admitted: int) -> float:
    """MLA decode's least time: each row's ``admitted`` latent positions
    (``rank + rope`` wide) read once, the float32 queries read and the
    float32 context written once, the int32 lengths; ``2 (2 rank + rope)``
    operations a head and admitted position."""
    b, h, r = q_abs
    flops = 2.0 * b * h * (2 * r + rope) * admitted
    nbytes = (elt * (r + rope) * b * admitted
              + 4 * (b * h * r + b * h * rope + b * h * r) + 4 * b)
    return least_seconds(flops, nbytes)
