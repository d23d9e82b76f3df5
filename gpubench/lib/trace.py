"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics
read.

The traced window is the host range ``gpubench.traced_window``.  Device
operations (kernels, copies, sets) are clipped to it; their union is the
time the device was busy, the rest is idle.  A kernel belongs to a
named host range (``gpubench.moe``, ``gpubench.attn``, ...) when the
runtime or driver call that launched it (the profiler's correlation id)
ran inside that range; where no launching call is in the trace, when
its start lies inside the range's device-side span.  Each idle gap of
the device is labelled with what the host was doing at its start: the
innermost benchmark range, and the innermost operator of the program
under it.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

from gpubench.lib.stats import merged

WINDOW = "gpubench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float                       # summed device-op time
    by_name: Dict[str, float]             # device-op time by name
    in_range: Dict[str, float]            # device-op time by host range
    gaps: List[Tuple[str, float]]         # longest idle gaps, labelled


class _Intervals:
    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def _innermost(events, t: float):
    best = None
    for e in events:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return best


def reduce(path: str, ranges: Tuple[str, ...], top: int = 10) -> Summary:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no traced window")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                dev.append((s, t, e))
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    host = {n: _Intervals([(e["ts"], e["ts"] + e["dur"]) for e in events
                           if e.get("name") == n
                           and e.get("cat") == "user_annotation"])
            for n in ranges}
    span = {n: _Intervals([(e["ts"], e["ts"] + e["dur"]) for e in events
                           if e.get("name") == n
                           and e.get("cat") == "gpu_user_annotation"])
            for n in ranges}
    by_name: Dict[str, float] = defaultdict(float)
    in_range: Dict[str, float] = defaultdict(float)
    for s, t, e in dev:
        d = (t - s) * 1e-6
        by_name[e["name"]] += d
        at = launch.get(e.get("args", {}).get("correlation"))
        for n in ranges:
            if (host[n].covers(at) if at is not None
                    else span[n].covers(e["ts"])):
                in_range[n] += d
    busy = merged([(s, t) for s, t, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    holes.sort(key=lambda g: g[0] - g[1])
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("gpubench.")
             and e.get("name") != WINDOW]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    gaps = []
    for g0, g1 in holes[:top]:
        mark = _innermost(marks, g0)
        op = _innermost(ops, g0)
        label = mark["name"] if mark else "host"
        if op is not None:
            label += f" / {op['name']}"
        gaps.append((label, (g1 - g0) * 1e-6))
    return Summary(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(t - s for s, t in busy) * 1e-6,
                   kernel_s=sum(t - s for s, t, _ in dev) * 1e-6,
                   by_name=dict(by_name), in_range=dict(in_range),
                   gaps=gaps)
