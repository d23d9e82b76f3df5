"""Continuous-batching engine over the port's real models.

Port of the reference package's ``repro.serving.continuous``.
Iteration-level scheduling (Orca / vLLM style) on the same model
bundles the static engine uses: a fixed pool of ``max_active`` KV-cache
slots; between decode steps, waiting requests are prefilled into free
slots (lowest slot first); finished sequences free theirs at once.
Measurement is the reference's virtual clock: arrivals on a Poisson
timeline, service durations the measured wall times of the real
prefills and decode steps, each ended by ``torch.cuda.synchronize()``.

The decode step runs at the full pool shape, as the reference's static
XLA shapes do: idle slots are masked out of the latency accounting but
not out of the compute (on a MoE model they are routed and take expert
capacity), and their lengths grow by one every step like the active
ones'.  An idle slot's length passes ``cache_len`` after ``cache_len``
steps; its decode writes nothing then (``attention._scatter_time``).
The cache is updated in place: ``_write_slot`` copies a one-row prefill
cache into the pool row of every layer's tensors (K/V, their int8
scales, or Mamba2's conv windows and state), and the warm-up's decode
step runs on a copy of the pool, which the reference's functional step
leaves unchanged.  Prompts are drawn from ``np.random.default_rng(seed)``
in admission order, as the reference draws them.  As in the reference,
a prefill takes the prompt's tokens alone: the VLM runs on its text,
and whisper, whose encoder has no frames then, raises ``ValueError``
at its first prefill, before any layer runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sweep import resolve_device
from repro_torch.models import build

__all__ = ["ContinuousEngine", "ContinuousServeResult"]


@dataclass
class ContinuousServeResult:
    lam: float
    n_jobs: int
    mean_latency: float
    latency_p50: float
    latency_p99: float
    mean_active: float
    utilization: float
    steps: int
    latencies: np.ndarray = field(repr=False)


class ContinuousEngine:
    """Slot-pool continuous batching over a real model.

    ``device`` is CUDA unless the caller asks for ``"cpu"``; without a
    GPU the default raises.  Weights come from a ``torch.Generator``
    seeded with ``seed`` on that device."""

    def __init__(self, cfg: ModelConfig, *, prompt_len: int = 16,
                 gen_tokens: int = 8, max_active: int = 8, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle = build(cfg)
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        self.max_active = max_active
        self.cache_len = prompt_len + gen_tokens + 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.bundle.init(gen)
        self._rng = np.random.default_rng(seed)
        with torch.inference_mode():
            self._pool_cache = self.bundle.init_cache(
                max_active, self.cache_len, device=self.device)
            self._pool_tok = torch.zeros(max_active, 1, dtype=torch.long,
                                         device=self.device)
            self._pool_len = torch.zeros(max_active, dtype=torch.int32,
                                         device=self.device)

    # ------------------------------------------------------------------
    def _prefill(self, params, tokens):
        """One prompt (1, prompt_len) → (first token (1, 1), cache)."""
        with torch.inference_mode():
            lg, cache = self.bundle.prefill(params, {"tokens": tokens},
                                            self.cache_len)
            return torch.argmax(lg[:, -1:], dim=-1), cache

    def _decode(self, params, tok, cache, lengths):
        """One greedy step of the whole pool (updates ``cache``)."""
        with torch.inference_mode():
            lg, cache = self.bundle.decode_step(params, tok, cache, lengths)
            return torch.argmax(lg, dim=-1), cache

    def _write_slot(self, slot: int, cache_one, tok_one) -> None:
        with torch.inference_mode():
            for pool, one in zip(self._pool_cache, cache_one):
                for name, t in pool.items():
                    t[slot].copy_(one[name][0])
            self._pool_tok[slot] = tok_one[0]
            self._pool_len[slot] = self.prompt_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        return out, time.perf_counter() - t0

    def _prompt(self) -> torch.Tensor:
        toks = self._rng.integers(0, self.cfg.vocab_size,
                                  size=(1, self.prompt_len))
        out = torch.as_tensor(toks, dtype=torch.long).to(self.device)
        self._sync()
        return out

    def warmup(self) -> None:
        toks = torch.zeros(1, self.prompt_len, dtype=torch.long,
                           device=self.device)
        (tok, cache), _ = self._timed(self._prefill, self.params, toks)
        self._write_slot(0, cache, tok)
        with torch.inference_mode():
            scratch = [{k: t.clone() for k, t in c.items()}
                       for c in self._pool_cache]
        self._timed(self._decode, self.params, self._pool_tok, scratch,
                    self._pool_len)

    # ------------------------------------------------------------------
    def serve_poisson(self, lam: float, n_jobs: int = 100,
                      seed: int = 0) -> ContinuousServeResult:
        self.warmup()
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / lam, size=n_jobs))
        now = 0.0
        busy = 0.0
        i = 0
        waiting: List[int] = []
        # slot -> [request id, remaining tokens] or None
        slots: List = [None] * self.max_active
        lat: Dict[int, float] = {}
        active_counts: List[int] = []
        steps = 0

        while len(lat) < n_jobs:
            while i < n_jobs and arrivals[i] <= now:
                waiting.append(i)
                i += 1
            free = [s for s, v in enumerate(slots) if v is None]
            # admit one waiting request per free slot (prefill inline)
            while waiting and free:
                req = waiting.pop(0)
                slot = free.pop(0)
                (tok, cache), dt = self._timed(self._prefill, self.params,
                                               self._prompt())
                self._write_slot(slot, cache, tok)
                slots[slot] = [req, self.gen_tokens]
                now += dt
                busy += dt
            active = [s for s, v in enumerate(slots) if v is not None]
            if not active:
                if i < n_jobs:
                    now = max(now, arrivals[i])
                    continue
                break
            active_counts.append(len(active))
            (tok, _), dt = self._timed(
                self._decode, self.params, self._pool_tok,
                self._pool_cache, self._pool_len)
            with torch.inference_mode():
                self._pool_tok = tok
                self._pool_len += 1
            now += dt
            busy += dt
            steps += 1
            for s in active:
                slots[s][1] -= 1
                if slots[s][1] == 0:
                    req = slots[s][0]
                    lat[req] = now - arrivals[req]
                    slots[s] = None

        latv = np.asarray([lat[j] for j in sorted(lat)][:n_jobs])
        return ContinuousServeResult(
            lam=lam, n_jobs=len(latv),
            mean_latency=float(latv.mean()),
            latency_p50=float(np.percentile(latv, 50)),
            latency_p99=float(np.percentile(latv, 99)),
            mean_active=float(np.mean(active_counts)),
            utilization=float(busy / now) if now else 0.0,
            steps=steps,
            latencies=latv)
