"""The plain reference: embedding, decoder layers, final norm, unembedding.

Everything in float32 (``exact_matmul`` turns TF32 off), layer by layer:
each layer's weights are asked for when the layer runs and dropped after
it, so the whole model is never held.  The configuration is the keys of
a Hugging Face ``config.json`` (``hidden_size``, ``num_hidden_layers``,
...); a configuration with ``n_routed_experts`` is DeepSeek-V2's (MLA
and a mixture of experts after ``first_k_dense_replace`` dense layers),
any other a dense GQA transformer with ``partial_rotary_factor`` of each
head rotated.

What it computes, and where it follows the program rather than the
published checkpoint (the benchmark's configuration files list these):

- RMSNorm with ``rms_norm_eps``; rotary embeddings in the half-split
  (rotate-half) layout over the first ``rot`` dims of a head, angles
  ``pos / theta ** (2i / rot)``; ``rope_scaling`` null, or DeepSeek's
  ``yarn`` (its frequencies blended between ``1 / factor`` and 1 over
  the correction range, cos and sin scaled by ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``, MLA's scores by ``mscale(factor,
  mscale_all_dim) ** 2``), which at ``factor`` 1 is plain RoPE.
- GQA: query head h reads kv head ``h // (H // KV)``; scores scaled by
  ``head_dim ** -0.5``; causal.
- MLA: ``q = x W_q`` (no q compression), the latent ``c = rmsnorm(x
  W_dkv)``, ``k_pe = rope(x W_kpe)`` shared by the heads, ``k = [c W_uk,
  k_pe]``, ``v = c W_uv``, scores scaled by ``(nope + rope) ** -0.5``.
- The MoE layer: a float32 router, softmax, the top-k by a stable
  descending sort (the lower expert index first among equal
  probabilities), no renormalisation; tokens routed in groups of
  ``moe_group_tokens`` consecutive tokens of the flattened (batch,
  position) order, the last group padded with zero rows; an expert's
  slots counted slot-major and token-minor, each expert keeping
  ``capacity(group)`` of them (GShard, ``moe_capacity_factor``) and
  dropping the rest; the kept slots weighted by their probability; the
  shared experts as one SwiGLU of ``n_shared_experts`` widths.
- Decoding is run teacher-forced: the served tokens are fed as the
  decode inputs.  The prompt's tokens are routed as one batch of
  groups and each decode step's tokens (one a row) as another, as a
  server that prefills and then decodes routes them.

``Reference(cfg, weights, device, precision)`` with ``weights(group)``
returning a dict of float32 tensors for the groups ``"embed"``,
``"head"`` and ``"layers.<i>"`` (the names ``lib.weights`` gives).
``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3, each row of the activations and each output
column of the weights on a scale of its own; the router, the norms and
the attention scores stay float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest finite float8 e4m3fn value


def exact_matmul() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 on one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """The matrix product of the reference (``float32``) or of its
    control (``fp8``)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., n) @ w (n, m)``."""
        if self.kind == "fp8":
            x = _fp8(x, -1)
            w = _fp8(w, 0)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def yarn_mscale(factor: float, m: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _yarn_dim(rotations: float, dim: int, theta: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (
        2 * math.log(theta))


def yarn(inv: torch.Tensor, scaling: dict, rot: int,
         theta: float) -> Tuple[torch.Tensor, float]:
    """DeepSeek-V2's YaRN: the frequencies ``inv`` blended towards
    ``inv / factor`` below the correction range, and the factor on cos and
    sin.  At ``factor`` 1 both are unchanged, bit for bit."""
    if scaling.get("type") != "yarn":
        raise ValueError(f"rope_scaling {scaling.get('type')!r}: the "
                         f"reference knows only yarn")
    f = float(scaling["factor"])
    max_pos = scaling["original_max_position_embeddings"]
    lo = max(math.floor(_yarn_dim(scaling["beta_fast"], rot, theta,
                                  max_pos)), 0)
    hi = min(math.ceil(_yarn_dim(scaling["beta_slow"], rot, theta,
                                 max_pos)), rot - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(rot // 2, dtype=torch.float32, device=inv.device)
             - lo) / (hi - lo)).clamp(0, 1)               # 1: interpolated
    inv = inv - (inv - inv / f) * ramp
    return inv, (yarn_mscale(f, scaling.get("mscale", 1.0))
                 / yarn_mscale(f, scaling.get("mscale_all_dim", 0.0)))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         rot: int, scaling: Optional[dict] = None) -> torch.Tensor:
    """x ``(B, L, H, D)``, pos ``(L,)``: the first ``rot`` dims of each head
    rotated in the half-split layout, under ``scaling`` (a configuration's
    ``rope_scaling``) where it is not None."""
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    m = 1.0
    if scaling is not None:
        inv, m = yarn(inv, scaling, rot, theta)
    ang = pos.float()[:, None] * inv                      # (L, rot/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    cos, sin = cos * m, sin * m
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x[..., rot:]], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, rows: int = 4, chunk: int = 1024) -> torch.Tensor:
    """Causal attention: q ``(B, L, H, Dk)``, k ``(B, L, KV, Dk)``, v ``(B,
    L, KV, Dv)``, position i admitting keys 0 … i; in blocks of ``rows``
    batch rows and ``chunk`` queries."""
    b, n, h, _ = q.shape
    g = h // k.shape[2]
    out = q.new_empty(b, n, h, v.shape[3])
    keys = torch.arange(n, device=q.device)
    for r0 in range(0, b, rows):
        kk = k[r0:r0 + rows].repeat_interleave(g, dim=2).transpose(1, 2)
        vv = v[r0:r0 + rows].repeat_interleave(g, dim=2).transpose(1, 2)
        for c0 in range(0, n, chunk):
            qq = q[r0:r0 + rows, c0:c0 + chunk].transpose(1, 2)
            s = (qq @ kk.transpose(-1, -2)) * scale     # (rb, H, c, L)
            mask = keys[None, :] <= torch.arange(
                c0, c0 + qq.shape[2], device=q.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[r0:r0 + rows, c0:c0 + chunk] = (p @ vv).transpose(1, 2)
    return out


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.mm(F.silu(P.mm(x, wg)) * P.mm(x, wu), wd)


def capacity(tokens_per_group: int, top_k: int, factor: float,
             experts: int) -> int:
    """Slots an expert keeps in a group: GShard's ``tokens · k · factor /
    E``, plus one, rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_group * top_k * factor / experts) + 1
    return max(4, c + (-c) % 4)


def route(logits: torch.Tensor, top_k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits ``(G, T, E)`` float32 → ``(expert, weight, keep)`` each ``(G,
    T, K)``: the chosen experts, their probabilities, and whether the
    slot is within its expert's capacity (slots counted slot-major)."""
    g, t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, expert = top_p[..., :top_k], expert[..., :top_k]
    sel = F.one_hot(expert, e).to(torch.int64)              # (G,T,K,E)
    order = sel.transpose(1, 2).reshape(g, top_k * t, e)    # slot-major
    before = torch.cumsum(order, dim=1) - order
    pos = (before.reshape(g, top_k, t, e).transpose(1, 2) * sel).sum(-1)
    keep = pos < cap
    return expert, top_p, keep


class Reference:
    def __init__(self, cfg: dict, weights: Callable[[str], Dict[str, torch.Tensor]],
                 device, precision: str = "float32"):
        self.cfg = cfg
        self.weights = weights
        self.device = torch.device(device)
        self.P = Precision(precision)
        self.moe = "n_routed_experts" in cfg
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.scaling = cfg.get("rope_scaling")
        sc = self.scaling or {}
        m = (yarn_mscale(float(sc["factor"]), sc["mscale_all_dim"])
             if sc.get("mscale_all_dim") else 1.0)
        self.score_mscale = m * m

    # -- layers ------------------------------------------------------------
    def _gqa(self, w, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        h, kv = c["num_attention_heads"], c["num_key_value_heads"]
        hd = d // h
        rot = int(hd * c.get("partial_rotary_factor", 1.0))
        rot -= rot % 2
        P = self.P
        q = P.mm(x, w["attn.wq"].reshape(d, h * hd)).view(b, n, h, hd)
        k = P.mm(x, w["attn.wk"].reshape(d, kv * hd)).view(b, n, kv, hd)
        v = P.mm(x, w["attn.wv"].reshape(d, kv * hd)).view(b, n, kv, hd)
        q = rope(q, pos, self.theta, rot, self.scaling)
        k = rope(k, pos, self.theta, rot, self.scaling)
        o = attention(q, k, v, hd ** -0.5)
        return P.mm(o.reshape(b, n, h * hd), w["attn.wo"].reshape(h * hd, d))

    def _mla(self, w, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        h = c["num_attention_heads"]
        nope, rp = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        vd, r = c["v_head_dim"], c["kv_lora_rank"]
        P = self.P
        q = P.mm(x, w["attn.wq"].reshape(d, h * (nope + rp))).view(
            b, n, h, nope + rp)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, self.theta,
                                           rp, self.scaling)], dim=-1)
        lat = rms_norm(P.mm(x, w["attn.w_dkv"]), w["attn.norm_ckv"], self.eps)
        k_pe = rope(P.mm(x, w["attn.w_kpe"])[:, :, None, :], pos, self.theta,
                    rp, self.scaling)
        k_nope = P.mm(lat, w["attn.w_uk"].reshape(r, h * nope)).view(
            b, n, h, nope)
        v = P.mm(lat, w["attn.w_uv"].reshape(r, h * vd)).view(b, n, h, vd)
        k = torch.cat([k_nope, k_pe.expand(b, n, h, rp)], dim=-1)
        o = attention(q, k, v, (nope + rp) ** -0.5 * self.score_mscale)
        return P.mm(o.reshape(b, n, h * vd), w["attn.wo"].reshape(h * vd, d))

    def _moe(self, w, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        e, k = c["n_routed_experts"], c["num_experts_per_tok"]
        total = b * n
        tg = min(int(c["moe_group_tokens"]), total)
        g = -(-total // tg)
        xf = x.reshape(total, d)
        if g * tg > total:
            xf = torch.cat([xf, xf.new_zeros(g * tg - total, d)])
        cap = capacity(tg, k, float(c["moe_capacity_factor"]), e)
        expert, weight, keep = route(
            xf.view(g, tg, d) @ w["ffn.router"], k, cap)
        tok = torch.arange(g * tg, device=x.device)[:, None].expand(
            g * tg, k)[keep.view(-1, k)]
        ex = expert.view(-1, k)[keep.view(-1, k)]
        wt = weight.view(-1, k)[keep.view(-1, k)]
        order = torch.argsort(ex, stable=True)
        tok, ex, wt = tok[order], ex[order], wt[order]
        counts = torch.bincount(ex, minlength=e).tolist()
        y = torch.zeros_like(xf)
        start = 0
        for i, cnt in enumerate(counts):
            if cnt:
                idx = tok[start:start + cnt]
                h = swiglu(xf[idx], w["ffn.w_gate"][i], w["ffn.w_up"][i],
                           w["ffn.w_down"][i], self.P)
                y.index_add_(0, idx, h * wt[start:start + cnt, None])
            start += cnt
        y = y[:total].view(b, n, d)
        return y + swiglu(x, w["ffn.shared.w_gate"], w["ffn.shared.w_up"],
                          w["ffn.shared.w_down"], self.P)

    def _ffn(self, i: int, w, x: torch.Tensor) -> torch.Tensor:
        if self.moe and i >= self.cfg["first_k_dense_replace"]:
            return self._moe(w, x)
        return swiglu(x, w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"],
                      self.P)

    # -- the model -----------------------------------------------------------
    def logits(self, prompts: torch.Tensor,
               decode: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """prompts ``(B, S)``, decode inputs ``(B, T)`` or None → the float32
        logits of the prompt's last position ``(B, V)`` and of each decode
        step ``(B, T, V)`` (None without decode inputs)."""
        exact_matmul()
        c = self.cfg
        s = prompts.shape[1]
        t = 0 if decode is None else decode.shape[1]
        ids = prompts if decode is None else torch.cat([prompts, decode], 1)
        ids = ids.to(self.device)
        emb = self.weights("embed")["embed"]
        x = emb[ids]
        del emb
        pos = torch.arange(s + t, device=self.device)
        for i in range(c["num_hidden_layers"]):
            w = self.weights(f"layers.{i}")
            h = rms_norm(x, w["norm1.scale"], self.eps)
            x = x + (self._mla(w, h, pos) if self.moe else
                     self._gqa(w, h, pos))
            h = rms_norm(x, w["norm2.scale"], self.eps)
            # the prompt's tokens and each decode step's are routed apart
            f = [self._ffn(i, w, h[:, :s])]
            f += [self._ffn(i, w, h[:, s + j:s + j + 1]) for j in range(t)]
            x = x + torch.cat(f, dim=1)
            del w, h, f
        w = self.weights("head")
        out = torch.cat([x[:, s - 1:s], x[:, s:]], dim=1)
        out = rms_norm(out, w["norm_f.scale"], self.eps)
        table = (self.weights("embed")["embed"].T
                 if c["tie_word_embeddings"] else w["unembed"])
        lg = self.P.mm(out, table)
        return lg[:, 0], (lg[:, 1:] if t else None)


def widest_gap(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per position: how far the served token's reference logit lies below
    the reference's best, ``ref (N, V)``, ``served (N,)``."""
    ref = ref.float()
    return ref.max(-1).values - ref.gather(
        -1, served.long().to(ref.device)[:, None])[:, 0]


def logit_error(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per position: the largest logit difference over the vocabulary, in
    units of the reference row's standard deviation."""
    ref = ref.float()
    return (got.float() - ref).abs().amax(-1) / ref.std(-1)
