"""The serve driver: the dynamic-batching server under an open loop of
requests in real time.

Set-up builds ``InferenceEngine`` over weights the benchmark drew from
the seed (``lib.port``), draws the requests (``lib.traffic``), and runs
each of the engine's buckets once on pad rows.  The window then offers
the requests at the times they are due, whatever the server is doing:
whenever the server is free, the policy (the paper's batch-all-waiting,
Eq. 2, capped at ``b_max``) takes the waiting requests, the batch is
padded to its pow2 bucket and runs through the engine's bucket function,
the call that ``run_batch`` times, ended by a synchronise.  A request's
latency runs from when it was due to the end of its batch; the window
closes when every request due in it has been served.

After the window, the peak memory is read and the program freed; then
the plain reference runs over a sample of the served batches, drawn from
the seed (the fullest first), and judges what the timed calls produced
(``check``).  A traced run (``--trace 1``) records the window's last
seconds with ``torch.profiler`` and reads the cell's per-layer metrics:
those from the trace over that slice, those from the host's clock over
the batches that ended before the profiler started, which it did not
slow.
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench.lib import catalog, port, stats, trace as tracelib
from gpubench.lib.flops import request_flops
from gpubench.lib.traffic import Requests
from gpubench.lib.weights import Weights, sub_seed
from gpubench.reference.model import Reference, logit_error, widest_gap

RANGES = (port.MOE_RANGE, port.ATTN_RANGE, port.MLA_RANGE)
ANSWER = "answer_"      # the end-to-end metrics of cells that decode
# what ``judge`` reads; a cell compares those its ``check.limits`` name
NUMBERS = ("gap_max", "logit_err_p50", "logit_err_max")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sleep_until(t: float) -> None:
    while True:
        dt = t - time.perf_counter()
        if dt <= 0:
            return
        time.sleep(dt - 5e-4 if dt > 1e-3 else 0)


class Server:
    """The program as a cell runs it: the engine over the benchmark's
    weights, its bucket functions captured, warmed on every bucket."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *,
                 strict: bool = True, trace: bool = False,
                 hooks: Optional[Callable] = None):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.seq_len = int(traffic["prompt_len"])
        self.gen_tokens = int(traffic.get("gen_tokens", 0))
        self.b_max = int(traffic["b_max"])
        self.pcfg = port.port_config(cfg, strict=strict)
        self.weights = Weights(cfg, seed, self.device)
        self.engine = port.build_engine(
            self.pcfg, self.weights, workload=traffic["workload"],
            seq_len=self.seq_len, gen_tokens=self.gen_tokens,
            b_max=self.b_max, device=self.device)
        self.policy = port.policy(traffic["policy"], self.b_max)
        self.capture = port.Capture(self.engine, self.seq_len)
        self.ranges = port.Ranges(self.capture) if trace else None
        if hooks is not None:
            hooks(self)

    def reseed(self, seed: int) -> None:
        """Draw another seed's weights into the same model."""
        self.weights = Weights(self.cfg, seed, self.device)
        self.weights.fill(self.engine.params)

    def call(self, batch: Dict[str, torch.Tensor]):
        rows = batch["tokens"].shape[0]
        self.capture.begin()
        out = port.bucket_call(self.engine, rows)(self.engine.params, batch)
        _sync(self.device)
        return out

    def warm(self, requests: Requests) -> None:
        for bb in self.engine.buckets:
            self.call(requests.batch([], bb))
        self.capture.begin()

    def close(self) -> None:
        if self.ranges is not None:
            self.ranges.remove()
        self.engine = self.capture = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclass
class Batch:
    ids: List[int]
    rows: int
    t_call: float
    t_end: float
    backlog: bool                  # requests were waiting when it ended
    t_form: float = 0.0            # when the loop began to form it
    tokens: torch.Tensor = None
    out: torch.Tensor = None
    logits: list = field(default_factory=list)


@dataclass
class Window:
    due: np.ndarray
    start: np.ndarray
    done: np.ndarray
    batches: List[Batch]
    late: List[float]              # how late the loop woke for a request
    trace: Optional[tracelib.Summary] = None
    traced_from: float = float("inf")   # when the profiler started

    @property
    def seconds(self) -> float:
        return float(self.done.max())

    def latencies(self) -> np.ndarray:
        return self.done - self.due

    def untraced(self) -> List[Batch]:
        """The batches that ended before the profiler started."""
        return [b for b in self.batches if b.t_end <= self.traced_from]

    def untraced_waits(self) -> np.ndarray:
        """Due to the start of the batch's call, for each request whose
        batch ended before the profiler started."""
        keep = self.done <= self.traced_from
        return self.start[keep] - self.due[keep]


class _Tracer:
    """Records the window's last ``plan["seconds"]`` (from the first batch
    boundary in that slice to the first after the window's end)."""

    def __init__(self, plan: dict, seconds: float, ranges: port.Ranges,
                 device):
        self.t0, self.t1 = max(0.0, seconds - plan["seconds"]), seconds
        self.ranges = ranges
        self.state = 0
        self.started = float("inf")
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.acts = acts
        # the profiler's first start initialises its tracer: in set-up
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            _sync(torch.device(device))
        self.prof = None
        self.window = None

    @property
    def on(self) -> bool:
        return self.state == 1

    def tick(self, now: float) -> None:
        """Start or stop at ``now``."""
        if self.state == 0 and now >= self.t0:
            self.started = now
            self.prof = profile(activities=self.acts)
            self.prof.start()
            self.window = record_function(tracelib.WINDOW)
            self.window.__enter__()
            self.ranges.logging = True
            self.state = 1
        elif self.state == 1 and now >= self.t1:
            self.stop()

    def stop(self) -> None:
        if self.state == 1:
            self.window.__exit__(None, None, None)
            self.ranges.logging = False
            self.prof.stop()
            self.state = 2

    def summary(self) -> tracelib.Summary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.prof = None
            return tracelib.reduce(path, RANGES)
        finally:
            os.unlink(path)


def serve(server: Server, requests: Requests,
          tracer: Optional[_Tracer] = None) -> Window:
    """One window: every request offered at its due time, served in
    batches as the server frees; returns the host records."""
    due = requests.due
    n = len(due)
    start = np.full(n, np.nan)
    done = np.full(n, np.nan)
    batches: List[Batch] = []
    late: List[float] = []
    queue: deque = deque()
    nxt = n_served = 0

    def span(name):
        return (record_function(name) if tracer is not None and tracer.on
                else contextlib.nullcontext())

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while n_served < n:
            now = time.perf_counter() - t0
            if tracer is not None:
                tracer.tick(now)
            while nxt < n and due[nxt] <= now:
                queue.append(nxt)
                nxt += 1
            if not queue:
                with span("gpubench.wait"):
                    _sleep_until(t0 + due[nxt])
                late.append(time.perf_counter() - t0 - due[nxt])
                continue
            t_form = now
            b = server.policy.take(len(queue))
            ids = [queue.popleft() for _ in range(b)]
            rows = server.engine.bucket_of(b)
            with span("gpubench.form_batch"):
                batch = requests.batch(ids, rows)
            t_call = time.perf_counter() - t0
            with span("gpubench.model_call"):
                out = server.call(batch)
            t_end = time.perf_counter() - t0
            start[ids] = t_call
            done[ids] = t_end
            n_served += b
            backlog = bool(queue) or (nxt < n and due[nxt] <= t_end)
            batches.append(Batch(ids, rows, t_call, t_end, backlog, t_form,
                                 tokens=batch["tokens"], out=out,
                                 logits=server.capture.logits))
        if tracer is not None:
            tracer.stop()
    finally:
        gc.enable()
    return Window(due, start, done, batches, late,
                  traced_from=tracer.started if tracer is not None
                  else float("inf"))


# ---------------------------------------------------------------------------
# What the timed calls produced, and the reference's judgement of it
# ---------------------------------------------------------------------------

def coupled_rows(cfg: dict, traffic: dict, rows: int) -> int:
    """How many consecutive rows of a batch of ``rows`` the program's
    results mix: 1 in a dense model; in a MoE model the rows that share a
    routing group (``moe_group_tokens`` consecutive tokens), and every row
    where decode steps route the batch's tokens together."""
    if "n_routed_experts" not in cfg:
        return 1
    if int(traffic.get("gen_tokens", 0)):
        return rows
    s = int(traffic["prompt_len"])
    tg = min(int(cfg["moe_group_tokens"]), rows * s)
    if tg % s == 0:
        return tg // s
    return 1 if s % tg == 0 else rows


def sample(window: Window, cfg: dict, traffic: dict, count: int,
           seed: int) -> List[tuple]:
    """At least ``count`` served requests drawn from the seed, with the
    rows their results depend on: units of coupled rows, the fullest
    first, then in a seeded order.  Returns ``(batch, rows the reference
    runs)`` for each batch drawn from."""
    units = []
    for i, b in enumerate(window.batches):
        u = coupled_rows(cfg, traffic, b.rows)
        for r0 in range(0, len(b.ids), u):
            units.append((i, list(range(r0, min(r0 + u, b.rows)))))
    real = [sum(r < len(window.batches[i].ids) for r in rows)
            for i, rows in units]
    first = max(range(len(units)), key=lambda j: (real[j], -j))
    rng = np.random.default_rng(sub_seed(seed, "check"))
    order = [first] + [j for j in rng.permutation(len(units)) if j != first]
    pick: Dict[int, set] = {}
    got = 0
    for j in order:
        if got >= count:
            break
        i, rows = units[j]
        pick.setdefault(i, set()).update(rows)
        got += real[j]
    return [(window.batches[i], sorted(rows)) for i, rows in sorted(
        pick.items())]


def served(batch: Batch, rows: List[int]) -> dict:
    """The sampled rows' prompts, decode inputs, served tokens ``(n, 1 +
    T)`` and the program's logits at each served position ``(n, 1 + T,
    V)``, on the host; ``real`` marks the rows that served a request."""
    idx = torch.as_tensor(rows)
    lg = torch.stack([t[idx.to(t.device)].float() for t in batch.logits],
                     dim=1).cpu()
    if batch.out.dim() == 1:                       # forward: one token
        toks = batch.out[idx.to(batch.out.device)][:, None].cpu()
        dec = None
    else:                                          # generate: prefill + T
        first = lg[:, 0].argmax(-1)[:, None]
        toks = torch.cat([first, batch.out[idx.to(batch.out.device)].cpu()],
                         dim=1)
        dec = toks[:, :-1]
    return dict(prompts=batch.tokens[idx.to(batch.tokens.device)].cpu(),
                decode=dec, tokens=toks, logits=lg,
                real=idx < len(batch.ids))


def judge(cfg: dict, items: List[dict], weights: Weights, device,
          control: bool = False) -> dict:
    """The reference over each sampled batch's rows, at every served
    position of the rows that served a request: the widest gap of a
    served token under the reference's best (``gap_max``), and the median
    and the largest logit error (``logit_err_p50``, ``logit_err_max``;
    ``logit_err_top``, the five largest).
    With ``control``, the same numbers for the fp8 control
    in the program's place, its own first token taken as served."""
    ref = Reference(cfg, weights.float32, device)
    ctl = Reference(cfg, weights.float32, device, precision="fp8")
    out = {"gap": [], "err": []}
    ctl_out = {"gap": [], "err": []}

    def positions(last, steps, real):
        want = last[:, None] if steps is None else torch.cat(
            [last[:, None], steps], dim=1)
        want = want[real.to(want.device)]
        return want.reshape(-1, want.shape[-1])

    for it in items:
        real = it["real"]
        last, steps = ref.logits(it["prompts"], it["decode"])
        want = positions(last, steps, real)
        toks = it["tokens"][real].reshape(-1)
        got = it["logits"][real].reshape(-1, want.shape[-1]).to(want.device)
        out["gap"].append(widest_gap(want, toks).cpu())
        out["err"].append(logit_error(got, want).cpu())
        if control:
            c = positions(*ctl.logits(it["prompts"], it["decode"]), real)
            ctl_out["gap"].append(widest_gap(want, c.argmax(-1)).cpu())
            ctl_out["err"].append(logit_error(c, want).cpu())
        del want, got

    def numbers(o):
        gap, err = torch.cat(o["gap"]), torch.cat(o["err"])
        return {"gap_max": gap.max().item(),
                "logit_err_p50": err.median().item(),
                "logit_err_max": err.max().item(),
                "logit_err_top": err.topk(min(5, err.numel())).values.tolist(),
                "positions": int(gap.numel())}

    res = numbers(out)
    if control:
        res["control"] = numbers(ctl_out)
    return res


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def end_to_end(window: Window, setup_s: float,
               prefix: str = "") -> Dict[str, float]:
    """The window's latencies and throughput, under names that start with
    ``prefix``, and the set-up time."""
    lat = window.latencies() * 1e3
    return {prefix + "latency_mean_ms": float(lat.mean()),
            prefix + "latency_p95_ms": stats.percentile(lat, 95),
            prefix + "throughput_rps": len(lat) / window.seconds,
            "setup_s": setup_s}


def context(cell: dict, cfg: dict, traffic: dict, window: Window,
            calls: list) -> SimpleNamespace:
    """What a per-layer metric's reader reads: the traced slice's summary
    and attention calls (``trace``, ``calls``), and the host's records of
    the batches that ended before the profiler started (``batches``) and
    of their requests' waits (``waits``, seconds)."""
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, trace=window.trace, calls=calls,
        batches=window.untraced(), waits=window.untraced_waits(),
        request_flops=request_flops(cfg, int(traffic["prompt_len"]),
                                    int(traffic.get("gen_tokens", 0))))


def run(cell: dict, cfg: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, t_start: float, device="cuda", strict: bool = True,
        hooks: Optional[Callable] = None, root=catalog.HERE) -> dict:
    device = torch.device(device)
    marks = {"imports": time.perf_counter() - t_start}
    server = Server(cfg, traffic, seed, device, strict=strict, trace=trace,
                    hooks=hooks)
    requests = Requests(traffic, seed, seconds, cfg["vocab_size"], device)
    _sync(device)
    marks["engine"] = time.perf_counter() - t_start
    server.warm(requests)
    marks["warm"] = time.perf_counter() - t_start
    tracer = (_Tracer(cell["trace"], seconds, server.ranges, device)
              if trace else None)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    window = serve(server, requests, tracer)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    calls = server.ranges.calls if server.ranges is not None else []
    if tracer is not None:
        window.trace = tracer.summary()
    items = [served(b, rows) for b, rows in sample(
        window, cfg, traffic, int(cell["check"]["requests"]), seed)]
    for b in window.batches:
        b.tokens = b.out = None
        b.logits = []
    weights = server.weights
    weights.keep = True               # the reference draws each group once
    server.close()
    del requests
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge(cfg, items, weights, device)
    marks["reference"] = time.perf_counter() - t_ref
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell["check"]["limits"].items()}
    correct = bool(checks) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    n = len(window.due)
    failed = int(np.isnan(window.done).sum())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct and failed == 0), "attempted": n,
           "failed": failed}
    if trace:
        ctx = context(cell, cfg, traffic, window, calls)
        metrics = {}
        for name in catalog.per_layer(cell["name"], root):
            value = catalog.metric(name, root).read(ctx)
            if value is not None:
                metrics[name] = value
        s = window.trace
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        out["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in sorted(
                s.by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k[:120], v] for k, v in s.gaps[:10]]}
    else:
        # a request that decodes an answer is timed to its last token: a
        # quantity of its own, whose noise (the decode loop's host
        # dispatch) prompt-only cells do not share
        metrics = end_to_end(window, setup_s, ANSWER
                             if traffic["workload"] == "generate" else "")
    units = {}
    for name in metrics:
        units[name] = _unit(name, root)
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in metrics.items()}
    out["device"] = dev
    late = np.asarray(window.late or [0.0]) * 1e3
    out["info"] = {
        "batches": len(window.batches),
        "mean_batch": float(np.mean([len(b.ids) for b in window.batches])),
        "window_s": window.seconds,
        "setup_marks_s": marks,
        "compared_tokens": numbers["positions"],
        "logit_err_top": numbers["logit_err_top"],
        "host_gaps_ms": _gaps(window.untraced()),
        "generator_late_ms_mean": float(late.mean()),
        "generator_late_ms_max": float(late.max()),
        "card": _power_limit() if device.type == "cuda" else None}
    out["checks"] = checks
    return out


def _gaps(batches: List[Batch]) -> dict:
    """``stats.host_gaps``: their count, median and largest, and the same
    of the part spent forming the next batch."""
    gap, form = stats.host_gaps(batches)
    if not len(gap):
        return {}
    return {"n": len(gap), "p50": float(np.median(gap) * 1e3),
            "max": float(gap.max() * 1e3),
            "form_p50": float(np.median(form) * 1e3),
            "form_max": float(form.max() * 1e3)}


_UNITS = {"latency_mean_ms": "ms", "latency_p95_ms": "ms",
          "throughput_rps": "req/s", "setup_s": "s"}


def _unit(name: str, root) -> str:
    base = name.removeprefix(ANSWER)
    if base in _UNITS:
        return _UNITS[base]
    return catalog.metric(name, root).UNIT
