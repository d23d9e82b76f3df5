"""Dynamic-batching inference engine — the system the paper characterizes.

Port of the reference package's ``repro.serving.engine``.  The engine
executes a real torch model (every family of the registry: dense, MoE,
MLA, Mamba2, the hybrid, whisper's enc-dec and the VLM; on the card
their attention and SSD scan run through the hand-written CUDA
kernels) under the paper's batch-service discipline:

- requests arrive (Poisson load generator, MLPerf-Server-Scenario style),
- whenever the server is free, a batching policy (default: the paper's
  batch-all-waiting, Eq. 2) forms the next batch from the queue,
- the batch is padded to a *bucket* size (powers of two up to
  max_batch, as in the reference, whose XLA shapes are static), and the
  padded rows run through the model like real ones,
- the batch runs to completion; per-request latency = departure − arrival.

Measurement is the reference's *virtual-clock, trace-driven* design:
arrivals are drawn on a virtual Poisson timeline, while service
durations are the measured wall-clock times of the real executions.
``run_batch`` times the model's execution only: the batch's tokens are
drawn and copied to the device, and the device synchronised, before the
clock starts, and the clock stops after ``torch.cuda.synchronize()``
(the reference's ``block_until_ready``).  As the reference does, a VLM's
batch carries float32 zero ``patch_embeds`` and whisper's float32 zero
``frames``, each ``(b, n_ctx, d_model)``.

Workloads:
  'forward'  — one full forward pass over a fixed-length input, then
               the argmax of the last position's logits
  'generate' — prefill(prompt_len) + gen_tokens greedy KV-cache decode
               steps (a Python loop where the reference scans); on
               the VLM, decoding starts at ``seq_len + n_ctx``, after
               the patch rows, as in the reference, and the cache holds
               ``n_ctx + seq_len + gen_tokens + 1`` positions where the
               reference's holds ``seq_len + gen_tokens + 1`` and so
               cannot take the prefill's n_ctx + seq_len (ROADMAP C-R4)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import fit_service_model
from repro_torch.core.policy import BatchAllWaiting, BatchPolicy
from repro_torch.core.sweep import resolve_device
from repro_torch.models import build
from repro_torch.models.registry import ModelBundle

__all__ = ["InferenceEngine", "ServeResult"]


def _buckets(max_batch: int) -> List[int]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


@dataclass
class ServeResult:
    lam: float
    n_jobs: int
    mean_latency: float
    latency_p50: float
    latency_p95: float
    latency_p99: float
    mean_batch: float
    utilization: float
    batch_sizes: np.ndarray = field(repr=False)
    latencies: np.ndarray = field(repr=False)
    bucket_of: Dict[int, int] = field(default_factory=dict, repr=False)


class InferenceEngine:
    """Single-logical-server dynamic-batching engine over a real model.

    ``device`` is CUDA unless the caller asks for ``"cpu"``; without a
    GPU the default raises.  Weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device, and the
    request tokens from ``np.random.default_rng(seed)`` as in the
    reference.  ``batches_run`` counts the ``run_batch`` calls."""

    def __init__(self, cfg: ModelConfig, *, workload: str = "forward",
                 seq_len: int = 64, gen_tokens: int = 4,
                 max_batch: int = 64, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle: ModelBundle = build(cfg)
        self.workload = workload
        self.seq_len = seq_len
        self.gen_tokens = gen_tokens
        self.max_batch = max_batch
        self.buckets = _buckets(max_batch)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.bundle.init(gen)
        self._fns: Dict[int, Callable] = {}
        self._rng = np.random.default_rng(seed)
        self.batches_run = 0
        self._build_fns()

    # ------------------------------------------------------------------
    def _make_batch(self, b: int) -> Dict[str, torch.Tensor]:
        """The reference's draw, as a batch on the device (the copy is
        complete when this returns)."""
        cfg = self.cfg
        toks = self._rng.integers(0, cfg.vocab_size, size=(b, self.seq_len))
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.long).to(
            self.device)}
        extra = {"vlm": "patch_embeds", "audio": "frames"}.get(cfg.family)
        if extra is not None and cfg.encoder is not None:
            batch[extra] = torch.zeros(b, cfg.encoder.n_ctx, cfg.d_model,
                                       device=self.device)
        self._sync()
        return batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_fns(self) -> None:
        bundle = self.bundle

        if self.workload == "forward":
            def run(params, batch):
                logits, _ = bundle.forward(params, batch)
                return torch.argmax(logits[:, -1], dim=-1)
        elif self.workload == "generate":
            # the VLM's patch rows, in front of the prompt
            cfg = self.cfg
            offset = (cfg.encoder.n_ctx
                      if cfg.family == "vlm" and cfg.encoder is not None
                      else 0)
            cache_len = offset + self.seq_len + self.gen_tokens + 1
            gen_tokens = self.gen_tokens

            def run(params, batch):
                logits, cache = bundle.prefill(params, batch, cache_len)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                bsz = tok.shape[0]
                lengths = torch.full((bsz,),
                                     batch["tokens"].shape[1] + offset,
                                     dtype=torch.int32, device=tok.device)
                toks = []
                for _ in range(gen_tokens):
                    lg, cache = bundle.decode_step(params, tok, cache,
                                                   lengths)
                    tok = torch.argmax(lg, dim=-1)
                    lengths = lengths + 1
                    toks.append(tok[:, 0])
                return torch.stack(toks, dim=1)
        else:
            raise ValueError(self.workload)

        def run_inference(params, batch):
            with torch.inference_mode():
                return run(params, batch)

        for b in self.buckets:
            self._fns[b] = run_inference

    def bucket_of(self, b: int) -> int:
        for bb in self.buckets:
            if b <= bb:
                return bb
        return self.buckets[-1]

    # ------------------------------------------------------------------
    def run_batch(self, b: int) -> float:
        """Execute one batch of b requests; return wall seconds."""
        bb = self.bucket_of(b)
        batch = self._make_batch(bb)
        t0 = time.perf_counter()
        self._fns[bb](self.params, batch)
        self._sync()
        self.batches_run += 1
        return time.perf_counter() - t0

    def warmup(self) -> None:
        for b in self.buckets:
            self.run_batch(b)

    # ------------------------------------------------------------------
    def calibrate(self, batch_sizes: Optional[Sequence[int]] = None,
                  samples: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """Measure τ^[b] (median of `samples`) for each bucket size —
        the paper's MultiStream-Scenario measurement (Fig. 9)."""
        bs = list(batch_sizes or self.buckets)
        self.warmup()
        med = []
        for b in bs:
            ts = [self.run_batch(b) for _ in range(samples)]
            med.append(float(np.median(ts)))
        return np.asarray(bs, float), np.asarray(med)

    def fit_service_model(self, samples: int = 5):
        b, t = self.calibrate(samples=samples)
        return fit_service_model(b, t)

    # ------------------------------------------------------------------
    def serve_poisson(self, lam: float, n_jobs: int = 500,
                      policy: BatchPolicy = BatchAllWaiting(),
                      seed: int = 0, warmup: bool = True) -> ServeResult:
        """Serve a Poisson(λ) request trace (λ in jobs per *second* of
        virtual time; service times are real measured wall seconds)."""
        if warmup:
            self.warmup()
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / lam, size=n_jobs))
        i = 0                      # next arrival index not yet queued
        now = 0.0
        busy = 0.0
        waiting: List[float] = []  # arrival times
        lat: List[float] = []
        batches: List[int] = []
        while len(lat) < n_jobs:
            if not waiting:
                # jump to next arrival
                now = max(now, arrivals[i])
                while i < n_jobs and arrivals[i] <= now:
                    waiting.append(arrivals[i])
                    i += 1
            # policy may delay service (timeout batching)
            start = policy.release_time(now, waiting[0], len(waiting))
            if start > now:
                # admit arrivals that land before the delayed start
                while i < n_jobs and arrivals[i] <= start:
                    waiting.append(arrivals[i])
                    i += 1
                now = start
            b = policy.take(len(waiting))
            batch_arr = waiting[:b]
            waiting = waiting[b:]
            svc = self.run_batch(b)
            depart = now + svc
            lat.extend(depart - a for a in batch_arr)
            batches.append(b)
            busy += svc
            while i < n_jobs and arrivals[i] <= depart:
                waiting.append(arrivals[i])
                i += 1
            now = depart
        latv = np.asarray(lat[:n_jobs])
        bsv = np.asarray(batches)
        return ServeResult(
            lam=lam, n_jobs=n_jobs,
            mean_latency=float(latv.mean()),
            latency_p50=float(np.percentile(latv, 50)),
            latency_p95=float(np.percentile(latv, 95)),
            latency_p99=float(np.percentile(latv, 99)),
            mean_batch=float(bsv.mean()),
            utilization=float(busy / now) if now > 0 else 0.0,
            batch_sizes=bsv,
            latencies=latv,
            bucket_of={b: self.bucket_of(b) for b in range(1,
                                                           self.max_batch
                                                           + 1)},
        )
