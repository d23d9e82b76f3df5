"""Streaming per-superstep observability for campaign-scale sweeps.

Own copy of the reference package's ``repro.core.metrics``:
``MetricsTap`` whole (plain Python), and ``tap_superstep`` as a host
read between supersteps.  Where the reference streams each lane's
scalars through an unordered ``io_callback`` from inside the jit
kernel, the port's sweeps call ``tap_superstep`` after each superstep
of their Python loop, only when a tap is attached: it stacks the seven
per-lane ``FIELDS`` into one float64 tensor, copies it to the host in
one transfer and feeds the lanes to ``MetricsTap._record`` in lane
order.  Every field is an int32 count or a float32 sum, so float64
holds it exactly.

Contract with the sweeps:

- the read only observes: attaching a tap changes nothing about a
  run's outputs (asserted bitwise by tests/test_torch_metrics.py), and
  an untapped run launches exactly what it launched before;
- the read synchronises the device once a superstep, so a tapped run
  is slower, never different.

JSONL schema (one object per line):

- ``{"type": "superstep", "step": int, "lanes": int,
  "queue_depth_mean": float, "jobs_total": int, "occupancy": float,
  "dropped_total": int, "overflow_total": int, "abandoned_total": int,
  "wall_s": float, "jobs_per_sec": float | null, "label": str}``
- ``{"type": "summary", "label": str, ...caller scalars}`` — emitted
  by ``observe_summary`` (the sweep entry points report final
  points/jobs and sketch percentile medians this way).
- ``{"type": "chunk", "label": str, ...}`` — one per campaign chunk
  (``observe_chunk``).

``wall_s`` is host time since the tap first heard from the dispatch;
``jobs_per_sec`` is the incremental rate since the previously flushed
superstep (null for the first).
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from typing import IO, Optional

__all__ = ["MetricsTap", "tap_superstep"]

# per-lane scalar payload streamed by the kernels, in callback order
FIELDS = ("queue", "jobs", "busy", "span", "dropped", "overflow",
          "abandoned")


class MetricsTap:
    """Host-side aggregation sink for per-superstep kernel telemetry.

    Parameters
    ----------
    jsonl_path : append-target for one JSON object per superstep
        (optional — the tap still aggregates for ``summary()``).
    prom_path : Prometheus-style text file, atomically rewritten on
        every flush (optional).
    label : tag attached to every record / metric line.
    expected_points : grid size of the tapped dispatch.  When set, a
        superstep flushes as soon as all lanes reported (streaming);
        otherwise everything flushes on ``close()``.
    """

    FIELDS = FIELDS

    def __init__(self, jsonl_path: Optional[str] = None,
                 prom_path: Optional[str] = None, *,
                 label: str = "sweep",
                 expected_points: Optional[int] = None):
        self.label = str(label)
        self.expected_points = expected_points
        self._lock = threading.Lock()
        self._agg: dict = {}          # step -> accumulators
        self._flushed: set = set()
        self._t0: Optional[float] = None
        self._last_flush: Optional[tuple] = None  # (wall_s, jobs_total)
        self.supersteps = 0
        self.records = 0
        self.latest: dict = {}
        self._prom_path = os.fspath(prom_path) if prom_path else None
        self._jsonl: Optional[IO[str]] = (
            open(os.fspath(jsonl_path), "a") if jsonl_path else None)

    # -- host callback ------------------------------------------------

    def _record(self, step, queue, jobs, busy, span, dropped, overflow,
                abandoned):
        """One (superstep, lane) sample, from ``tap_superstep`` —
        keep it allocation-light."""
        now = time.perf_counter()
        step = int(step)
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.records += 1
            a = self._agg.get(step)
            if a is None:
                a = self._agg[step] = [0, 0.0, 0, 0.0, 0.0, 0, 0, 0]
            a[0] += 1          # lanes reported for this superstep
            a[1] += float(queue)
            a[2] += int(jobs)  # cumulative per lane → sum over lanes
            a[3] += float(busy)
            a[4] += float(span)
            a[5] += int(dropped)
            a[6] += int(overflow)
            a[7] += int(abandoned)
            if (self.expected_points is not None
                    and a[0] == self.expected_points
                    and step not in self._flushed):
                self._flush_locked(step, now)

    def _flush_locked(self, step: int, now: float) -> None:
        a = self._agg.pop(step)
        lanes = a[0]
        wall = now - (self._t0 or now)
        jobs_total = a[2]
        rate = None
        if self._last_flush is not None:
            dt = wall - self._last_flush[0]
            dj = jobs_total - self._last_flush[1]
            if dt > 0 and dj >= 0:
                rate = dj / dt
        rec = {
            "type": "superstep", "step": step, "lanes": lanes,
            "queue_depth_mean": a[1] / max(lanes, 1),
            "jobs_total": jobs_total,
            "occupancy": a[3] / a[4] if a[4] > 0 else 0.0,
            "dropped_total": a[5], "overflow_total": a[6],
            "abandoned_total": a[7], "wall_s": wall,
            "jobs_per_sec": rate, "label": self.label,
        }
        self._flushed.add(step)
        self._last_flush = (wall, jobs_total)
        self.supersteps += 1
        self.latest = rec
        self._emit(rec)
        self._write_prom(rec)

    # -- output -------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def _write_prom(self, rec: dict) -> None:
        if self._prom_path is None:
            return
        tag = f'{{label="{self.label}"}}'
        lines = [
            "# HELP repro_supersteps_total supersteps flushed",
            "# TYPE repro_supersteps_total counter",
            f"repro_supersteps_total{tag} {self.supersteps}",
            "# HELP repro_jobs_total measured jobs completed",
            "# TYPE repro_jobs_total counter",
            f"repro_jobs_total{tag} {rec['jobs_total']}",
            "# HELP repro_queue_depth_mean mean queue depth over lanes",
            "# TYPE repro_queue_depth_mean gauge",
            f"repro_queue_depth_mean{tag} {rec['queue_depth_mean']:.6g}",
            "# HELP repro_occupancy busy fraction of simulated span",
            "# TYPE repro_occupancy gauge",
            f"repro_occupancy{tag} {rec['occupancy']:.6g}",
            "# HELP repro_dropped_total buffer-dropped jobs",
            "# TYPE repro_dropped_total counter",
            f"repro_dropped_total{tag} {rec['dropped_total']}",
            "# HELP repro_overflow_total admission-rejected jobs",
            "# TYPE repro_overflow_total counter",
            f"repro_overflow_total{tag} {rec['overflow_total']}",
            "# HELP repro_abandoned_total deadline-abandoned jobs",
            "# TYPE repro_abandoned_total counter",
            f"repro_abandoned_total{tag} {rec['abandoned_total']}",
            "# HELP repro_jobs_per_sec incremental measured-job rate",
            "# TYPE repro_jobs_per_sec gauge",
            f"repro_jobs_per_sec{tag} "
            f"{(rec['jobs_per_sec'] or 0.0):.6g}",
            "",
        ]
        d = os.path.dirname(self._prom_path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write("\n".join(lines))
            os.replace(tmp, self._prom_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def observe_summary(self, **scalars) -> None:
        """Append a free-form ``summary`` record (final percentiles,
        totals — whatever the caller wants on the wire).  NaNs are
        nulled so the line stays strict JSON."""
        clean = {k: (None if isinstance(v, float) and not
                     math.isfinite(v) else v)
                 for k, v in scalars.items()}
        with self._lock:
            self._emit({"type": "summary", "label": self.label,
                        **clean})

    def observe_chunk(self, **scalars) -> None:
        """Append a ``chunk`` record — the campaign driver streams one
        per completed chunk (index, points, pad waste, loss totals,
        wall time) for mid-flight progress watching.

        Campaign tap contract: a tapped run reads its lanes back once
        a superstep, so the campaign does NOT attach the tap to every
        chunk — ``campaign(metrics_tap=..., tap_every=N)`` taps every
        N-th chunk's *run* (full per-superstep telemetry for those
        chunks); all chunks still stream this record.  Because a tap
        is bitwise-neutral, tapped and untapped campaigns produce
        identical accumulators (asserted by
        tests/test_torch_campaign.py)."""
        clean = {k: (None if isinstance(v, float) and not
                     math.isfinite(v) else v)
                 for k, v in scalars.items()}
        with self._lock:
            self._emit({"type": "chunk", "label": self.label,
                        **clean})

    def summary(self) -> dict:
        """Aggregate view so far (thread-safe snapshot)."""
        with self._lock:
            return {"supersteps": self.supersteps,
                    "records": self.records,
                    "pending": len(self._agg), **{
                        k: self.latest.get(k) for k in
                        ("jobs_total", "occupancy", "jobs_per_sec")}}

    def close(self) -> None:
        """Flush stragglers (in step order) and release the JSONL
        handle.  Idempotent."""
        now = time.perf_counter()
        with self._lock:
            for step in sorted(self._agg):
                self._flush_locked(step, now)
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def __enter__(self) -> "MetricsTap":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def tap_superstep(tap: Optional[MetricsTap], step: int, **vals) -> None:
    """Stream one superstep's per-lane scalars to ``tap`` (no-op when
    ``tap`` is None, so the sweeps call it unconditionally): one
    device→host copy of the ``FIELDS`` stacked as float64, then one
    ``_record`` per lane in lane order.  ``vals`` maps field names to
    ``(P,)`` tensors; a missing field reads 0 — the lossless sweeps
    have no overflow/abandon counters."""
    if tap is None:
        return
    import torch

    like = next(v for v in vals.values() if isinstance(v, torch.Tensor))
    cols = [vals[f].to(torch.float64) if f in vals
            else torch.zeros(like.shape, dtype=torch.float64,
                             device=like.device) for f in FIELDS]
    rows = torch.stack(cols, dim=1).cpu().tolist()
    step = int(step)
    for queue, jobs, busy, span, dropped, overflow, abandoned in rows:
        tap._record(step, queue, int(jobs), busy, span, int(dropped),
                    int(overflow), int(abandoned))
