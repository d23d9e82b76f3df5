"""The model's weights, made by the benchmark from the seed.

``param_spec(cfg)`` names every parameter of a configuration as the
program's model names it (``embed``, ``norm_f.scale``, ``unembed``,
``layers.<i>.attn.wq`` ...), with its shape, its served dtype and how it
is drawn.  ``Weights(cfg, seed, device)`` draws them one group at a time
(the embedding, the head, each layer) with one ``torch.Generator`` call a
group, seeded from the seed and the group's name: the same seed gives the
same bits on the same device, and any group can be drawn again alone.
``fill(module)`` writes them into a model's parameters by name;
``float32(group)`` hands the reference the same values (the served dtype's
rounding, then float32).

Matrices are normal draws times ``fan_in ** -0.5`` (the embedding times
0.02), norm scales ``1 + 0.1 · N(0, 1)``; the router is float32, every
other weight the configuration's dtype.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one named draw."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _layer_spec(cfg: dict, i: int) -> Spec:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    out: Spec = [("norm1.scale", (d,), "norm", 0.0)]
    if "kv_lora_rank" in cfg:
        nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
        out += [("attn.wq", (d, h, nope + rp), "w", d ** -0.5),
                ("attn.w_dkv", (d, r), "w", d ** -0.5),
                ("attn.w_kpe", (d, rp), "w", d ** -0.5),
                ("attn.norm_ckv", (r,), "norm", 0.0),
                ("attn.w_uk", (r, h, nope), "w", r ** -0.5),
                ("attn.w_uv", (r, h, vd), "w", r ** -0.5),
                ("attn.wo", (h, vd, d), "w", (h * vd) ** -0.5)]
    else:
        kv = cfg["num_key_value_heads"]
        hd = d // h
        out += [("attn.wq", (d, h, hd), "w", d ** -0.5),
                ("attn.wk", (d, kv, hd), "w", d ** -0.5),
                ("attn.wv", (d, kv, hd), "w", d ** -0.5),
                ("attn.wo", (h, hd, d), "w", (h * hd) ** -0.5)]
    out.append(("norm2.scale", (d,), "norm", 0.0))
    if "n_routed_experts" in cfg and i >= cfg["first_k_dense_replace"]:
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        fs = cfg["n_shared_experts"] * f
        out += [("ffn.router", (d, e), "router", d ** -0.5),
                ("ffn.w_gate", (e, d, f), "w", d ** -0.5),
                ("ffn.w_up", (e, d, f), "w", d ** -0.5),
                ("ffn.w_down", (e, f, d), "w", f ** -0.5),
                ("ffn.shared.w_gate", (d, fs), "w", d ** -0.5),
                ("ffn.shared.w_up", (d, fs), "w", d ** -0.5),
                ("ffn.shared.w_down", (fs, d), "w", fs ** -0.5)]
    else:
        f = cfg["intermediate_size"]
        out += [("ffn.w_gate", (d, f), "w", d ** -0.5),
                ("ffn.w_up", (d, f), "w", d ** -0.5),
                ("ffn.w_down", (f, d), "w", f ** -0.5)]
    return out


def param_spec(cfg: dict) -> Dict[str, Spec]:
    """Group name → [(name within the group, shape, kind, scale)]; a
    parameter's full name is ``<group>.<name>`` for a layer, ``<name>``
    otherwise."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    groups: Dict[str, Spec] = {"embed": [("embed", (v, d), "w", 0.02)]}
    head: Spec = [("norm_f.scale", (d,), "norm", 0.0)]
    if not cfg["tie_word_embeddings"]:
        head.append(("unembed", (d, v), "w", d ** -0.5))
    groups["head"] = head
    for i in range(cfg["num_hidden_layers"]):
        groups[f"layers.{i}"] = _layer_spec(cfg, i)
    return groups


def full_name(group: str, name: str) -> str:
    return f"{group}.{name}" if group.startswith("layers.") else name


class Weights:
    def __init__(self, cfg: dict, seed: int, device):
        self.spec = param_spec(cfg)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["torch_dtype"]]
        # with ``keep``, each group's served tensors are drawn once and
        # kept (the reference's passes, once the program is freed)
        self.keep = False
        self._kept: Dict[str, Dict[str, torch.Tensor]] = {}

    def draw(self, group: str) -> Dict[str, torch.Tensor]:
        """The group's tensors in their served dtypes: one normal draw of
        the whole group, cut into its tensors."""
        spec = self.spec[group]
        sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
        z = torch.randn(sum(sizes), generator=generator(
            self.seed, group, self.device), device=self.device,
            dtype=torch.float32)
        out, at = {}, 0
        for (name, shape, kind, scale), n in zip(spec, sizes):
            t = z[at:at + n].view(shape)
            at += n
            if kind == "norm":
                out[name] = (1.0 + 0.1 * t).to(self.dtype)
            elif kind == "router":
                out[name] = t * scale
            else:
                out[name] = (t * scale).to(self.dtype)
        return out

    def float32(self, group: str) -> Dict[str, torch.Tensor]:
        if not self.keep:
            return {k: t.float() for k, t in self.draw(group).items()}
        if group not in self._kept:
            self._kept[group] = self.draw(group)
        return {k: t.float() for k, t in self._kept[group].items()}

    def fill(self, module: torch.nn.Module) -> None:
        """Write every group into ``module``'s parameters by name; raise if
        the module's parameters and the spec differ in a name, a shape or
        a dtype."""
        params = dict(module.named_parameters())
        want = {full_name(g, n): (shape, torch.float32 if kind == "router"
                                  else self.dtype)
                for g, spec in self.spec.items()
                for n, shape, kind, _ in spec}
        have = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
        if have != want:
            diff = sorted(set(have.items()) ^ set(want.items()))
            raise ValueError(f"the model's parameters differ from the "
                             f"benchmark's spec: {diff[:8]}")
        with torch.no_grad():
            for g in self.spec:
                for n, t in self.draw(g).items():
                    params[full_name(g, n)].copy_(t)
