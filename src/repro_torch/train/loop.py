"""Training of the port's models: the loss, the train step and a simple
driver.

Port of the reference package's ``repro.train.loop``.  The cross-entropy
is the reference's (float32, token mean, z-loss 1e-4); at ``S · V >=
CE_CHUNK_THRESHOLD`` with ``S`` a multiple of ``CE_CHUNK`` the loss takes
the final hidden states (``transformer.forward_hidden``) and computes
the logits ``CE_CHUNK`` positions at a time, each chunk under
``torch.utils.checkpoint``, so that the float32 ``(B, S, V)`` logits
never exist whole (the unembedding stays a torch product, as the
reference's is outside any Pallas kernel).  Both constants are read at
each call.  A step differentiates the loss with autograd, through the
hand-written backward kernels on the card (B3's in
``kernels.flash_attention``, B5's in ``kernels.ssd_scan``), and applies
``optimizer.apply_updates`` in place.  Every family of the registry
trains on the card, the SSM and hybrid ones included; on the CPU every
family trains through the plain versions, which autograd
differentiates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._mesh import (is_dtensor, local_call,
                                       seq_offset)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import batch_rows
from repro_torch.train.data import DataConfig, SyntheticCorpus
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         apply_updates, decay_names,
                                         init_state)

__all__ = ["CE_CHUNK", "CE_CHUNK_THRESHOLD", "cross_entropy",
           "chunked_cross_entropy", "loss_fn", "make_train_step",
           "require_trainable", "resolve_device", "device_batch",
           "TrainResult", "train"]

CE_CHUNK = 512
CE_CHUNK_THRESHOLD = 1 << 26     # S·V at and above which the loss chunks


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         z_loss: float) -> torch.Tensor:
    """Per-position softmax cross-entropy with z-loss, in float32."""
    if is_dtensor(logits):
        return _nll_mesh(logits, labels, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def _nll_mesh(logits, labels, z_loss: float):
    """``_nll`` on DTensor logits ``(B, S, V)``.  Where no mesh dimension
    of more than one rank splits the vocabulary, each rank runs ``_nll``
    on its own rows (``local_map``: on one rank the plain path's bits).
    Where one does (``unembed`` sharded on V), the vocab-parallel form:
    the log-sum-exp from the local maxima and sums of exponentials, which
    DTensor merges with a max and a sum all-reduce of ``(B, S)`` values,
    and the gold logit from the rank that holds the label, summed across
    the vocabulary shards — never an all-gather of the logits."""
    mesh = logits.device_mesh
    if not is_dtensor(labels):
        labels = distribute_tensor(labels, mesh,
                                   [Replicate()] * mesh.ndim)
    vocab = [i for i, p in enumerate(logits.placements)
             if p == Shard(2) and mesh.size(i) > 1]
    rows = [p if p in (Shard(0), Shard(1)) else Replicate()
            for p in logits.placements]
    if not vocab:
        return local_call(lambda lg, lb: _nll(lg, lb, z_loss), mesh,
                          (rows, rows), rows, logits, labels,
                          out_shapes=labels.shape)
    logits = logits.float()
    lay = [Shard(2) if i in vocab else p for i, p in enumerate(rows)]
    logits = logits.redistribute(mesh, lay)
    # the (B, S) statistics are all-reduced to the rows' own layout, so
    # their gradients reach the vocabulary-sharded logits with no gather
    m = logits.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
    se = torch.exp(logits - m).sum(dim=-1, keepdim=True).redistribute(
        mesh, rows)
    lse = (torch.log(se) + m)[..., 0]
    v_all = logits.shape[-1]

    def gold_part(lg, lb):
        idx = lb.long() - seq_offset(mesh, vocab, v_all)
        ok = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(ok, g[..., 0], 0.0)

    gold = local_call(gold_part, mesh, (lay, rows),
                      [Partial() if i in vocab else p
                       for i, p in enumerate(rows)], logits, labels,
                      out_shapes=labels.shape).redistribute(mesh, rows)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean softmax cross-entropy with z-loss (float32)."""
    return _nll(logits, labels, z_loss).mean()


def chunked_cross_entropy(cfg: ModelConfig, params: tfm.Transformer,
                          hidden: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 1e-4,
                          chunk: int = 0) -> torch.Tensor:
    """``cross_entropy(_logits(hidden), labels)`` with the logits made
    ``chunk`` (default ``CE_CHUNK``) positions at a time, each chunk
    checkpointed: the same value and gradients as the plain path, with
    at most ``(B, chunk, V)`` logits alive."""
    chunk = chunk or CE_CHUNK
    b, s, _ = hidden.shape
    # on a mesh, gather a sequence-sharded hidden once, not once a chunk
    hidden = batch_rows(hidden)

    def body(h, lab):
        return _nll(tfm._logits(cfg, params, h), lab, z_loss).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s - s % chunk, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            body, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
    return total / (b * s)


def loss_fn(cfg: ModelConfig, params: tfm.Transformer,
            batch: Dict[str, torch.Tensor], *, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + the MoE aux weight × aux, {"ce", "aux"}); on a VLM the patch
    positions are dropped before the loss."""
    labels = batch["labels"]
    s = labels.shape[1]
    chunked = (s % CE_CHUNK == 0
               and s * cfg.vocab_size >= CE_CHUNK_THRESHOLD)
    if chunked:
        hidden, aux = tfm.forward_hidden(cfg, params, batch, remat=remat)
        if hidden.shape[1] != s:        # VLM: drop the patch positions
            hidden = hidden[:, -s:]
        ce = chunked_cross_entropy(cfg, params, hidden, labels)
    else:
        logits, aux = tfm.forward(cfg, params, batch, remat=remat)
        if logits.shape[1] != s:
            logits = logits[:, -s:]
        ce = cross_entropy(logits, labels)
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


def require_trainable(cfg: ModelConfig, device) -> None:
    """Raise ``NotImplementedError`` where the port cannot train ``cfg``
    on ``device``: a family outside the registry.  Every registered
    family trains on CUDA and on the CPU."""
    tfm.require_supported(cfg)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = False, microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> (model,
    opt_state, metrics)``: the loss's gradients by autograd, then one
    AdamW step in place on the model's parameters (which it turns to
    ``requires_grad``).  ``metrics`` holds ``loss``, ``ce``, ``aux`` and
    ``grad_norm`` as float32 tensors on the model's device; nothing is
    read back to the host.  ``microbatches > 1`` splits the batch axis
    and accumulates ``g.float() / microbatches`` in float32, as the
    reference's scan does (and, as there, its ``ce`` is then the mean
    total loss)."""

    def grads_of(model, params, batch):
        loss, parts = loss_fn(cfg, model, batch, remat=remat)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), got)}
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            grads

    def train_step(model: tfm.Transformer, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        require_trainable(cfg, model.embed.device)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if microbatches == 1:
            loss, parts, grads = grads_of(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            m = b // microbatches
            grads = {n: p.new_zeros(p.shape, dtype=torch.float32)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.embed.device)
            aux = torch.zeros_like(loss)
            for i in range(microbatches):
                li, pi, gi = grads_of(model, params, {
                    k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                for n, g in gi.items():
                    grads[n] += g.float() / microbatches
                loss = loss + li / microbatches
                aux = aux + pi["aux"] / microbatches
            parts = {"ce": loss, "aux": aux}
        opt_state, gnorm = apply_updates(opt, params, grads, opt_state,
                                         decay_names(cfg, model))
        return model, opt_state, {"loss": loss, "ce": parts["ce"],
                                  "aux": parts["aux"].float(),
                                  "grad_norm": gnorm}

    return train_step


def device_batch(cfg: ModelConfig, batch: Dict[str, np.ndarray],
                 device) -> Dict[str, torch.Tensor]:
    """A corpus batch on ``device``: int64 tokens and labels, and the
    reference trainer's float32 zero ``patch_embeds`` (VLM) or
    ``frames`` (audio) of ``(B, n_ctx, d)``."""
    out = {k: torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)
           for k, v in batch.items()}
    b = out["tokens"].shape[0]
    if cfg.family in ("vlm", "audio") and cfg.encoder is not None:
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        out[key] = torch.zeros(b, cfg.encoder.n_ctx, cfg.d_model,
                               dtype=torch.float32, device=device)
    return out


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA; CUDA without a card raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port trains on an NVIDIA GPU and none is "
                           "visible; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


@dataclass
class TrainResult:
    steps: int
    first_loss: float
    last_loss: float
    losses: List[float]


def train(cfg: ModelConfig, *, steps: int = 50, seed: int = 0,
          global_batch: int = 8, seq_len: int = 64,
          opt: Optional[AdamWConfig] = None, log_every: int = 10,
          device=None) -> TrainResult:
    """Single-device training driver: the port's seeded weights, the
    synthetic corpus, ``steps`` train steps; on CUDA unless ``device`` is
    given."""
    require_trainable(cfg, device if device is not None else "cuda")
    dev = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps,
                             warmup_steps=max(steps // 10, 1))
    model = tfm.init_params(cfg, torch.Generator(device=dev)
                            .manual_seed(seed))
    opt_state = init_state(model)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq_len,
                                      global_batch=global_batch, seed=seed))
    losses = []
    for i, batch in zip(range(steps), data.batches()):
        model, opt_state, m = step_fn(model, opt_state,
                                      device_batch(cfg, batch, dev))
        losses.append(float(m["loss"]))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"ce {float(m['ce']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")
    return TrainResult(steps=steps, first_loss=losses[0],
                       last_loss=losses[-1], losses=losses)
