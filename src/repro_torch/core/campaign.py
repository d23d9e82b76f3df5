"""Chunked campaign driver: million-point design-space sweeps as a
stream of fixed-shape runs on the card, with the reduction on the card.

Port of the reference package's ``repro.core.campaign``.
``evaluate()`` materialises per-point results for one run and blocks on
it; at 10⁶+ points the host-side transfer and per-point buffers
dominate, not the kernels.  ``campaign(grid, ...)`` instead cuts the
grid into fixed-size chunks and runs each through the sweep's plan
(``sweep_plan`` / ``fleet_plan`` / ``gen_plan``) on ``device`` — CUDA
unless the caller asks for the CPU:

- **Pinned caps.**  The capacities are derived once from the FULL grid
  (``sweep_caps`` / ``fleet_caps`` / ``gen_caps``) and splatted into
  every chunk, so every chunk runs the shapes of the whole-grid run and
  a point's result is the same bits whatever the chunking.  The naive
  per-chunk loop (``mode="serial"``, the pre-campaign workflow)
  re-derives the caps per chunk.
- **Pipelined dispatch.**  Everything runs on one CUDA stream, in
  order.  Chunk i's run and fold are enqueued, its small summary (and
  any due checkpoint copy of the accumulator) goes to pinned host
  memory with ``non_blocking=True`` behind a CUDA event, and the host
  slices and enqueues chunk i+1 while the card works; ``drain_one``
  waits on the oldest event.  ``pipeline_depth`` bounds the chunks in
  flight.  One stream keeps the fold order equal to the chunk order,
  which the bitwise contract below needs.
- **Streaming reduction on the card.**  Per-point outputs never reach
  the host: the CUDA kernel ``kernels.campaign_fold`` folds each
  chunk's outputs into a campaign accumulator on the card, in place
  (histogram counts, loss totals, float64 running sums, and top-K
  worst-latency / best-goodput cells with their global indices).  Host
  traffic per chunk is O(bins + K).  A checkpoint's copy is taken on
  the stream before the next fold writes the accumulator.

Determinism contract (the chunk-invariance witness): per-point results
are bitwise chunk-invariant already (per-point keys + pinned caps), and
the campaign fold is a *sequential left fold in global point order*.
Chunk boundaries change where the sequence is cut, never the sequence
itself, and padded tail lanes fold as masked identities (integer +0,
float64 +0.0 onto non-negative sums, no top-K replacement).  So
``campaign(chunk_size=64)`` and ``campaign(chunk_size=n)`` produce
bitwise-identical accumulators — including the float64 sums, whose
addition order is identical, not merely associative.  Resume replays
the same fold from a checkpointed prefix, so a killed-and-resumed
campaign is also bitwise-identical to an uninterrupted one.

Accumulator precision: the fold runs in float64/int64; the sweeps keep
their float32/int32 dtypes.  Histogram form: by default chunks carry
the sweeps' full-resolution ``n_bins=512`` counts, whose merge is exact
integer addition; ``sketch=True`` switches to the 64-bin streaming
sketch and its per-bin sums (``hist.SKETCH_REL_ERR`` contract).

Checkpoint/resume: pass ``out_dir`` to persist per-chunk JSONL rows, an
``accumulator.npz`` and a ``manifest.json`` (grid/config fingerprints,
chunks_done).  ``resume=True`` validates the fingerprints, reloads the
accumulator, truncates the row log to the checkpointed prefix, and
continues at chunk ``chunks_done``.  The files are the reference's.

Adaptive precision: ``mode="adaptive"`` replaces the fixed per-point
cycle count with a convergence-aware schedule — a short pilot pass
triages every point's batch-means CI half-width, allocation snaps to
pow2 multiples of the pilot length, and a compacted final pass re-runs
each point at its allocated length with its own key
(``prng.point_keys_at``).  See ``campaign()`` and ``_run_adaptive``.

Mid-flight inspection: ``metrics_tap=`` + ``tap_every=N`` attaches the
per-superstep ``MetricsTap`` to every N-th chunk's run (it reads the
lanes back once a superstep); a tap changes no bit, so tapped and
untapped campaigns are identical.  Each completed chunk also streams a
``chunk`` record through the tap.

Fault tolerance, as in the reference, with its seeded injection hooks
(``fault_plan=FaultPlan(...)``):

- **Dispatch retry.**  A failed chunk run (an injected
  ``CampaignFault`` or a ``RuntimeError`` raised while it is enqueued)
  is retried up to ``fault_retries`` times with exponential backoff; a
  chunk that exhausts its retries is *quarantined* — skipped, recorded
  in the manifest and its row, never silently dropped.
- **Non-finite fold guard.**  The fold masks any point whose float
  statistics are not finite out of the accumulator (bitwise neutral
  when everything is finite) and counts it in ``quarantined_points``.
- **Checkpoint generations.**  ``checkpoint()`` records the
  accumulator's sha256 in the manifest and rotates the previous
  verified-good accumulator to ``accumulator.prev.npz``; resume walks
  current → prev → fresh.  ``verify_resume()`` is the packaged witness.

A sticky CUDA error (a faulting kernel) surfaces at the next
synchronisation, in ``drain_one``, outside the retry: it ends the
campaign rather than turning into a quarantined chunk.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.grid import FleetGrid, GenGrid, SweepGrid
from repro_torch.core.hist import (SKETCH_BINS, hist_edges, hist_percentiles,
                                   sketch_edges)
from repro_torch.core.sweep import _require_ported_options, resolve_device
from repro_torch.core.variance import allocate_cycles, batch_means_stats
from repro_torch.kernels.campaign_fold import (FoldAcc, campaign_fold,
                                               summary_dict)

__all__ = ["campaign", "plan_chunks", "operating_points",
           "CampaignResult", "DEFAULT_TOP_K",
           "FaultPlan", "CampaignFault", "CampaignKilled",
           "verify_resume"]

MANIFEST_VERSION = 2
DEFAULT_TOP_K = 16

# accumulator keys, in the canonical (fingerprint/checkpoint) order
_ACC_INT = ("points", "jobs", "batches", "buffer_dropped",
            "overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
            "n_retry", "quarantined_points")
_ACC_F64 = ("sum_latency_jobs", "sum_latency", "sum_util", "sum_batch")
_ACC_KEYS = (("hist", "hist_sums") + _ACC_INT + _ACC_F64
             + ("max_ci",)
             + ("top_lat_val", "top_lat_idx",
                "top_good_val", "top_good_idx"))

# fallback per-point cycle caps for mode="adaptive" when the caller
# does not pass n_batches/n_steps — the sweeps' own defaults
_DEFAULT_CYCLES = {"sweep": 3000, "fleet": 6000, "gen": 4096}
# allocation quantum per kind: sweep/fleet supersteps are 32 steps,
# gen_plan rounds n_steps up to its 2048-step bucket
_CYCLE_QUANTUM = {"sweep": 32, "fleet": 32, "gen": 2048}


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class CampaignFault(RuntimeError):
    """An injected (or injectable) per-chunk failure — dispatch
    errors raised by a ``FaultPlan`` are instances of this, and the
    driver's retry loop treats a ``RuntimeError`` of the run (a
    failed kernel launch, an out-of-memory) the same way."""


class CampaignKilled(RuntimeError):
    """Raised by ``_kill_after_chunks`` — a deterministic stand-in
    for SIGKILL mid-campaign, AFTER the chunk's row (and any due
    checkpoint) hit disk but with later chunks unpersisted.  Carries
    ``chunks_drained``."""

    def __init__(self, chunks_drained: int):
        super().__init__(f"campaign killed after draining "
                         f"{chunks_drained} chunks (injected)")
        self.chunks_drained = chunks_drained


_FAULT_KINDS = ("dispatch", "nan", "corrupt")


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic fault schedule for a campaign.

    Each potential injection site draws a uniform from
    ``sha256(seed, kind, chunk, attempt)`` — a pure function of the
    site, so an interrupted-and-resumed campaign replays *exactly*
    the faults the uninterrupted one saw (the resume-parity witness
    depends on this), and retry attempt ``a+1`` re-rolls instead of
    deterministically refailing.  ``max_per_chunk`` caps injections
    per (chunk, kind): once ``attempt`` reaches it the roll is
    forced clean, so a plan with ``p_dispatch=1.0`` still lets a
    sufficiently-retried chunk through.

    - ``p_dispatch``: chunk dispatch raises ``CampaignFault``
      (exercises the bounded-retry-with-backoff path).
    - ``p_nan``: the chunk's fold inputs are NaN-poisoned
      (exercises the fold's non-finite quarantine guard).
    - ``p_corrupt``: the checkpoint accumulator write is truncated
      (exercises sha validation + generation fallback on resume).
    """

    seed: int = 0
    p_dispatch: float = 0.0
    p_nan: float = 0.0
    p_corrupt: float = 0.0
    max_per_chunk: int = 2

    def __post_init__(self):
        for k in ("p_dispatch", "p_nan", "p_corrupt"):
            p = getattr(self, k)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultPlan.{k}={p} not in [0, 1]")

    def roll(self, kind: str, chunk_idx: int, attempt: int = 0) -> bool:
        """True iff the plan injects a ``kind`` fault at this site."""
        if kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        p = getattr(self, f"p_{kind}")
        if p <= 0.0 or attempt >= self.max_per_chunk:
            return False
        h = hashlib.sha256(
            f"faultplan:{self.seed}:{kind}:{chunk_idx}:{attempt}"
            .encode()).digest()
        return int.from_bytes(h[:8], "big") < p * 2.0 ** 64

    def to_config(self) -> dict:
        return {"seed": int(self.seed),
                "p_dispatch": float(self.p_dispatch),
                "p_nan": float(self.p_nan),
                "p_corrupt": float(self.p_corrupt),
                "max_per_chunk": int(self.max_per_chunk)}


# ---------------------------------------------------------------------------
# chunk planning (pad-waste accounting)
# ---------------------------------------------------------------------------

def plan_chunks(n_points: int, chunk_size: int) -> Tuple[int, int, int]:
    """Pick the actual chunk size for an ``n_points`` campaign.

    Repeated-last-point tail padding silently *recomputes* up to
    ``chunk_size - 1`` points, so prefer a divisor of ``n_points``
    near the requested size (searched down to 2/3 of it); otherwise
    keep the request and report the padded-point count so dispatch
    payloads can log the waste.  Returns ``(chunk_size, n_chunks,
    padded_points)``."""
    if n_points <= 0:
        raise ValueError("empty campaign")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1 (got {chunk_size})")
    chunk_size = min(int(chunk_size), n_points)
    if n_points % chunk_size:
        for d in range(chunk_size, max(1, (2 * chunk_size) // 3) - 1,
                       -1):
            if n_points % d == 0:
                chunk_size = d
                break
    n_chunks = -(-n_points // chunk_size)
    padded = n_chunks * chunk_size - n_points
    return chunk_size, n_chunks, padded


def operating_points(grid, mean_latency, *, slo: float,
                     ci_halfwidth=None,
                     by=("alpha", "tau0", "b_max")) -> Dict:
    """Max-λ operating point per hardware slice under a latency SLO.

    Scans per-point mean latencies (``point_stats["mean_latency"]``
    from an adaptive campaign, or any evaluated grid's means) and, for
    each distinct combination of the ``by`` grid axes, returns the
    highest-λ point whose mean latency meets ``slo``.  When
    ``ci_halfwidth`` is given the comparison uses the conservative
    upper confidence bound ``mean + halfwidth`` (NaN half-widths count
    as 0 — exact backends).  NaN means never qualify.  Ties on λ keep
    the lowest global index.  Returns ``{by-values tuple: {"gidx",
    "lam", "mean_latency"} | None}`` with ``None`` for slices that
    have no feasible point."""
    lat = np.asarray(mean_latency, np.float64)
    if lat.shape[0] != len(grid):
        raise ValueError(f"mean_latency has {lat.shape[0]} entries "
                         f"for a {len(grid)}-point grid")
    bound = lat.copy()
    if ci_halfwidth is not None:
        bound = bound + np.nan_to_num(
            np.asarray(ci_halfwidth, np.float64), nan=0.0)
    lam = np.asarray(grid.lam, np.float64)
    axes = [np.asarray(getattr(grid, k)) for k in by]
    out: Dict = {}
    for i in range(len(grid)):
        key = tuple(a[i].item() for a in axes)
        out.setdefault(key, None)
        if not bound[i] <= slo:           # NaN-safe: NaN never passes
            continue
        cur = out[key]
        if cur is None or lam[i] > cur["lam"]:
            out[key] = {"gidx": i, "lam": float(lam[i]),
                        "mean_latency": float(lat[i])}
    return out


def _grid_sha(grid) -> str:
    h = hashlib.sha256(type(grid).__name__.encode())
    for a in grid._arrays():
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _kind_of(grid) -> str:
    if isinstance(grid, GenGrid):
        return "gen"
    if isinstance(grid, FleetGrid):
        return "fleet"
    if isinstance(grid, SweepGrid):
        return "sweep"
    raise TypeError(f"campaign cannot stream a {type(grid).__name__}")


def _kind_fns(kind: str):
    """(plan_fn, caps_fn, steps_kw) for a sweep kind: the port's plan
    and caps functions."""
    if kind == "sweep":
        from repro_torch.core.sweep import sweep_caps, sweep_plan
        return sweep_plan, sweep_caps, "n_batches"
    if kind == "fleet":
        from repro_torch.core.fleet import fleet_caps, fleet_plan
        return fleet_plan, fleet_caps, "n_steps"
    from repro_torch.core.gen_sweep import gen_caps, gen_plan
    return gen_plan, gen_caps, "n_steps"


# ---------------------------------------------------------------------------
# the accumulator (folded on the card by kernels.campaign_fold)
# ---------------------------------------------------------------------------

def _init_acc(n_bins: int, k_top: int) -> Dict[str, np.ndarray]:
    acc: Dict[str, np.ndarray] = {
        "hist": np.zeros(n_bins, np.int64),
        "hist_sums": np.zeros(n_bins, np.float64),
    }
    for k in _ACC_INT:
        acc[k] = np.zeros((), np.int64)
    for k in _ACC_F64:
        acc[k] = np.zeros((), np.float64)
    # campaign-wide max of the per-point 95% CI half-widths (0.0 until
    # a point with >= 2 regeneration blocks folds in); max-merged, so
    # bitwise chunk-invariant like the sums
    acc["max_ci"] = np.zeros((), np.float64)
    # -inf sentinels: any real value beats an empty slot, and the
    # strict-> replacement rule keeps the earliest index on ties
    acc["top_lat_val"] = np.full(k_top, -np.inf, np.float64)
    acc["top_lat_idx"] = np.full(k_top, -1, np.int64)
    acc["top_good_val"] = np.full(k_top, -np.inf, np.float64)
    acc["top_good_idx"] = np.full(k_top, -1, np.int64)
    return acc


# ---------------------------------------------------------------------------
# result
# ---------------------------------------------------------------------------

@dataclass
class CampaignResult:
    """Aggregates of one campaign run.

    ``hist`` is the merged latency histogram (bin-for-bin equal to the
    one-dispatch histogram), ``totals`` the campaign-wide job/loss
    counters, ``top_latency``/``top_goodput`` the retained (global
    point index, value) cells.  ``fingerprint()`` hashes the canonical
    accumulator bytes — the chunk-invariance and resume witnesses
    compare these."""

    kind: str
    mode: str
    n_points: int
    n_chunks: int
    chunk_size: int
    padded_points: int
    completed: bool
    sketch: bool
    acc: Dict[str, np.ndarray] = field(repr=False)
    rows: List[dict] = field(repr=False)
    wall_s: float = 0.0
    peak_host_result_bytes: int = 0
    serial_compile_shapes: int = 0
    tapped_chunks: int = 0
    out_dir: Optional[str] = None
    # -- adaptive mode only ------------------------------------------------
    pilot_jobs: int = 0                   # measured jobs spent on triage
    point_stats: Optional[Dict[str, np.ndarray]] = field(
        default=None, repr=False)         # per-point host arrays (O(n))
    # -- fault accounting --------------------------------------------------
    quarantined_chunks: List[dict] = field(default_factory=list)
    fault_events: List[dict] = field(default_factory=list)

    @property
    def hist(self) -> np.ndarray:
        return self.acc["hist"]

    @property
    def hist_bin_edges(self) -> np.ndarray:
        if self.sketch:
            return sketch_edges()
        return hist_edges(self.hist.shape[0])

    @property
    def totals(self) -> Dict[str, int]:
        return {k: int(self.acc[k]) for k in _ACC_INT}

    @property
    def mean_latency(self) -> float:
        """Jobs-weighted campaign mean latency (exact f64 fold of
        per-point means — no histogram binning error)."""
        jobs = int(self.acc["jobs"])
        if jobs == 0:
            return float("nan")
        return float(self.acc["sum_latency_jobs"]) / jobs

    @property
    def mean_utilization(self) -> float:
        pts = int(self.acc["points"])
        return float(self.acc["sum_util"]) / max(pts, 1)

    @property
    def mean_batch(self) -> float:
        pts = int(self.acc["points"])
        return float(self.acc["sum_batch"]) / max(pts, 1)

    @property
    def max_ci_halfwidth(self) -> float:
        """Largest per-point 95% CI half-width (regenerative batch
        means) folded into the campaign; 0.0 until a point with >= 2
        blocks folds in.  Adaptive campaigns drive this under
        ``target_ci``."""
        return float(self.acc["max_ci"])

    @property
    def quarantined_points(self) -> int:
        """Points whose statistics were masked out of the fold by the
        non-finite guard (plus any whole-chunk dispatch quarantines
        recorded in ``quarantined_chunks``).  A campaign with faults
        reports what it lost — it never silently drops work."""
        n = int(self.acc["quarantined_points"])
        n += sum(int(q["points"]) for q in self.quarantined_chunks
                 if q.get("reason") == "dispatch")
        return n

    @property
    def simulated_jobs(self) -> int:
        """Total measured jobs simulated, INCLUDING the triage pilot
        pass in adaptive mode — the cost metric adaptive campaigns are
        benchmarked on."""
        return int(self.acc["jobs"]) + int(self.pilot_jobs)

    @property
    def goodput_frac(self) -> float:
        offered = (int(self.acc["jobs"])
                   + int(self.acc["overflow_dropped"])
                   + int(self.acc["abandoned"]))
        if offered == 0:
            return 1.0
        return int(self.acc["n_in_slo"]) / offered

    def percentiles(self, qs=(50, 95, 99)) -> List[float]:
        """Campaign-wide latency percentiles from the merged counts
        (within one bin width of the exact sample percentile — the
        same contract as a single dispatch, see docs/theory.md)."""
        out = hist_percentiles(self.hist[None, :], qs,
                               edges=self.hist_bin_edges)
        return [float(v[0]) for v in out]

    def _ranked(self, vkey: str, ikey: str) -> List[Tuple[int, float]]:
        vals, idxs = self.acc[vkey], self.acc[ikey]
        keep = idxs >= 0
        order = np.lexsort((idxs[keep], -vals[keep]))
        return [(int(idxs[keep][o]), float(vals[keep][o]))
                for o in order]

    @property
    def top_latency(self) -> List[Tuple[int, float]]:
        """Worst mean-latency cells, (global point index, ms)."""
        return self._ranked("top_lat_val", "top_lat_idx")

    @property
    def top_goodput(self) -> List[Tuple[int, float]]:
        """Best goodput-rate cells, (global point index, jobs/ms)."""
        return self._ranked("top_good_val", "top_good_idx")

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for k in _ACC_KEYS:
            a = np.ascontiguousarray(self.acc[k])
            h.update(k.encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        return h.hexdigest()


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


class _Store:
    """manifest.json + accumulator.npz + chunks.jsonl under out_dir.

    Checkpoints are integrity-checked and two-generation: the
    manifest records the accumulator's sha256, and the previous
    *verified-good* accumulator is rotated to ``accumulator.prev.npz``
    before each write.  ``load_acc_checked`` walks current → prev →
    fresh, so a torn/corrupted write costs recomputed chunks, never a
    wrong (or unstartable) resume."""

    def __init__(self, out_dir: Path):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        self.acc_path = self.dir / "accumulator.npz"
        self.prev_path = self.dir / "accumulator.prev.npz"
        self.rows_path = self.dir / "chunks.jsonl"
        self._rows_fh = None

    def load_manifest(self) -> Optional[dict]:
        if not self.manifest_path.exists():
            return None
        return json.loads(self.manifest_path.read_text())

    def load_acc(self) -> Dict[str, np.ndarray]:
        with np.load(self.acc_path) as z:
            return {k: np.asarray(z[k]) for k in z.files}

    @staticmethod
    def _acc_from_bytes(data: bytes) -> Dict[str, np.ndarray]:
        import io
        with np.load(io.BytesIO(data)) as z:
            return {k: np.asarray(z[k]) for k in z.files}

    def load_acc_checked(self, man: dict):
        """Validate and load the checkpointed accumulator.

        Returns ``(acc | None, chunks_done, events)``: the newest
        generation whose bytes match its recorded sha256, or
        ``(None, 0, events)`` when every generation is corrupt or
        missing — the campaign then restarts from chunk 0, which
        still yields a bitwise-correct result (the fold sequence is
        deterministic).  ``events`` records every detection/fallback
        so recovery is visible, never silent."""
        events: List[dict] = []
        gens = [(self.acc_path, man.get("acc_sha"),
                 int(man.get("chunks_done", 0)), "current")]
        prev = man.get("prev")
        if prev:
            gens.append((self.prev_path, prev.get("acc_sha"),
                         int(prev.get("chunks_done", 0)), "prev"))
        for path, sha, done, gen in gens:
            if not path.exists():
                events.append({"event": "checkpoint_missing",
                               "generation": gen})
                continue
            data = path.read_bytes()
            if sha is not None and \
                    hashlib.sha256(data).hexdigest() != sha:
                events.append({"event": "checkpoint_corrupt",
                               "generation": gen,
                               "chunks_done": done})
                continue
            try:
                acc = self._acc_from_bytes(data)
            except Exception:
                events.append({"event": "checkpoint_unreadable",
                               "generation": gen,
                               "chunks_done": done})
                continue
            if gen != "current":
                events.append({"event": "checkpoint_recovered",
                               "generation": gen,
                               "chunks_done": done})
            return acc, done, events
        events.append({"event": "checkpoint_restart", "chunks_done": 0})
        return None, 0, events

    def truncate_rows(self, chunks_done: int) -> List[dict]:
        """Keep only rows for chunks < chunks_done (rows appended
        after the last checkpoint describe chunks the resume will
        recompute)."""
        rows: List[dict] = []
        if self.rows_path.exists():
            for line in self.rows_path.read_text().splitlines():
                if not line.strip():
                    continue
                row = json.loads(line)
                if row["chunk"] < chunks_done:
                    rows.append(row)
        _atomic_write(self.rows_path,
                      ("".join(json.dumps(r) + "\n" for r in rows))
                      .encode())
        return rows

    def append_row(self, row: dict) -> None:
        if self._rows_fh is None:
            self._rows_fh = open(self.rows_path, "a")
        self._rows_fh.write(json.dumps(row) + "\n")
        self._rows_fh.flush()

    def checkpoint(self, manifest: dict, acc: Dict[str, np.ndarray],
                   *, corrupt: bool = False) -> None:
        import io
        buf = io.BytesIO()
        np.savez(buf, **acc)
        data = buf.getvalue()
        manifest = dict(manifest)
        manifest["acc_sha"] = hashlib.sha256(data).hexdigest()
        # rotate the previous generation — but only if its on-disk
        # bytes still match the sha the old manifest recorded (a
        # corrupted current generation must never displace the last
        # good one)
        old = self.load_manifest()
        if old is not None and old.get("acc_sha") \
                and self.acc_path.exists():
            if hashlib.sha256(self.acc_path.read_bytes()).hexdigest() \
                    == old["acc_sha"]:
                _atomic_write(self.prev_path,
                              self.acc_path.read_bytes())
                manifest["prev"] = {
                    "chunks_done": int(old["chunks_done"]),
                    "acc_sha": old["acc_sha"]}
            else:
                manifest["prev"] = old.get("prev")
        if corrupt:
            # injected torn write: the file loses its tail but the
            # manifest keeps the intended sha — exactly what a
            # mid-write crash leaves behind
            data = data[:max(len(data) // 3, 1)]
        _atomic_write(self.acc_path, data)
        _atomic_write(self.manifest_path,
                      (json.dumps(manifest, indent=1) + "\n").encode())

    def close(self) -> None:
        if self._rows_fh is not None:
            self._rows_fh.close()
            self._rows_fh = None


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    total = 0
    for v in tree.values() if isinstance(tree, dict) else tree:
        total += np.asarray(v).nbytes
    return total


class _HostCopies:
    """Copies of device tensors into host memory that complete behind
    the work already enqueued on the stream: pinned buffers written with
    ``non_blocking=True`` and one CUDA event a batch on the card; plain
    clones on the CPU, where every op has completed when it returns."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t.clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(ev) -> None:
        if ev is not None:
            ev.synchronize()


def _limits_check(vals: np.ndarray, limits) -> None:
    """A run's ``"_limits"`` invariants, their values read back."""
    for got, (_, bound, msg) in zip(vals.tolist(), limits):
        if got > bound:
            raise RuntimeError(msg.format(got=got, bound=bound))


def campaign(grid, *, chunk_size: int = 4096, mode: str = "pipelined",
             n_bins: int = 512, sketch: bool = False, seed: int = 0,
             shard=None, superstep_backend: Optional[str] = None,
             metrics_tap=None, tap_every: int = 0,
             k_top: int = DEFAULT_TOP_K,
             pipeline_depth: int = 2, checkpoint_every: int = 8,
             out_dir: Optional[str] = None, resume: bool = False,
             stop_after_chunks: Optional[int] = None,
             caps: Optional[Dict[str, int]] = None,
             pilot: Optional[int] = None,
             target_ci: Optional[float] = None,
             refine_budget: Optional[int] = None,
             safety: float = 1.0,
             keep_point_stats: bool = False,
             fault_plan: Optional[FaultPlan] = None,
             fault_retries: int = 3,
             fault_backoff_s: float = 0.02,
             _kill_after_chunks: Optional[int] = None,
             device=None,
             **kernel_kw) -> CampaignResult:
    """Stream ``grid`` through its sweep in fixed-shape chunks on
    ``device`` (CUDA unless ``device="cpu"``) and reduce on the card
    (module docstring has the full execution model).

    ``grid`` picks the sweep: ``SweepGrid`` → ``sweep``, ``FleetGrid``
    → ``fleet_sweep``, ``GenGrid`` → ``gen_sweep``; ``**kernel_kw``
    (``n_batches``/``n_steps``/``warmup``/``hist_every``/...) forwards
    to it.  ``caps`` overrides the full-grid pinned capacities
    (defaults to ``*_caps(grid)``).  ``superstep_backend`` is the
    sweeps' (``"torch"`` / ``"cuda"`` / ``"auto"``).

    ``mode="pipelined"`` is the streaming driver; ``mode="serial"`` is
    the pre-campaign baseline it is measured against — a blocking
    per-chunk loop through the sweep's *result* path with per-chunk
    caps and full per-point host materialisation, folded on the host.
    Serial results agree statistically but are NOT bitwise-comparable
    to streaming ones (other caps ⇒ other arrival-draw shapes).

    ``stop_after_chunks=s`` checkpoints and returns after ``s`` chunks
    (``completed=False``); pass ``resume=True`` with the same
    ``out_dir``, grid and config to continue.

    ``fault_plan=FaultPlan(...)`` arms the seeded fault-injection
    harness (pipelined mode only): dispatch failures are retried up
    to ``fault_retries`` times with ``fault_backoff_s``-based
    exponential backoff (exhaustion quarantines the chunk), NaN
    poison is absorbed by the fold's non-finite guard, and checkpoint
    corruption is caught by the store's sha validation on resume.
    ``_kill_after_chunks=k`` raises ``CampaignKilled`` after draining
    ``k`` chunks — the hard-kill half of the ``verify_resume`` witness.

    ``mode="adaptive"`` is the convergence-aware scheduler: a short
    pilot pass (``pilot`` cycles per point, default ~n_max/16) triages
    every point's CI half-width, then ``target_ci=x`` sizes each point
    to reach half-width ``x`` (pow2 multiples of the pilot, capped at
    ``n_batches``/``n_steps``) or ``refine_budget=B`` Neyman-allocates
    ``B`` extra cycles ∝ CI (``safety > 1`` over-allocates).  Every
    point is re-run at its allocated length in compacted fixed-shape
    chunks per tier, with its own key; pilot-length points re-run
    bitwise their pilot.  Only the final pass folds, tiers ascending
    and global index ascending within a tier, so the accumulator does
    not depend on the chunking.  ``stop_after_chunks`` counts
    final-pass chunks (the pilot always completes and is checkpointed
    with the triage table before the final pass starts)."""
    kind = _kind_of(grid)
    plan_fn, caps_fn, steps_kw = _kind_fns(kind)
    n = len(grid)
    c_size, n_chunks, padded = plan_chunks(n, chunk_size)
    if mode not in ("pipelined", "serial", "adaptive"):
        raise ValueError(f"unknown campaign mode {mode!r}")
    if mode != "adaptive" and (pilot is not None or target_ci is not None
                               or refine_budget is not None):
        raise ValueError("pilot/target_ci/refine_budget require "
                         "mode='adaptive'")
    if mode != "pipelined" and (fault_plan is not None
                                or _kill_after_chunks is not None):
        raise ValueError("fault_plan/_kill_after_chunks target the "
                         "streaming driver (mode='pipelined')")
    if fault_retries < 0:
        raise ValueError(f"fault_retries must be >= 0 "
                         f"(got {fault_retries})")
    # raised here, never inside the dispatch retry (NotImplementedError
    # and a missing device are RuntimeErrors it would quarantine)
    _require_ported_options(shard, c_size, device)
    dev = resolve_device(device)
    if sketch:
        n_bins = SKETCH_BINS
    pinned = dict(caps) if caps is not None else caps_fn(grid)

    n_max = int(kernel_kw.get(steps_kw, _DEFAULT_CYCLES[kind]))
    if mode == "adaptive":
        if metrics_tap is not None:
            raise ValueError("mode='adaptive' does not support "
                             "metrics_tap")
        if (target_ci is None) == (refine_budget is None):
            raise ValueError("mode='adaptive' needs exactly one of "
                             "target_ci / refine_budget")
        q = _CYCLE_QUANTUM[kind]
        if pilot is None:
            pilot = min(n_max, max(4 * q, n_max // 16))
        pilot = -(-int(pilot) // q) * q      # round up to the quantum
        if not 0 < pilot <= n_max:
            raise ValueError(f"pilot={pilot} must be in (0, "
                             f"{steps_kw}={n_max}]")

    config = {"kind": kind, "mode": mode, "n_points": n,
              "chunk_size": c_size,
              "n_bins": int(n_bins), "sketch": bool(sketch),
              "seed": int(seed), "k_top": int(k_top),
              "caps": {k: int(v) for k, v in sorted(pinned.items())},
              "kernel_kw": {k: repr(v)
                            for k, v in sorted(kernel_kw.items())}}
    if mode == "adaptive":
        config["adaptive"] = {
            "pilot": int(pilot), "n_max": int(n_max),
            "target_ci": (None if target_ci is None
                          else float(target_ci)),
            "refine_budget": (None if refine_budget is None
                              else int(refine_budget)),
            "safety": float(safety)}
    if fault_plan is not None:
        # part of the config fingerprint: a resume must replay the
        # SAME fault schedule or bitwise parity is meaningless
        config["fault_plan"] = fault_plan.to_config()
    grid_sha = _grid_sha(grid)

    store = _Store(Path(out_dir)) if out_dir is not None else None
    start_chunk = 0
    rows: List[dict] = []
    acc_host: Optional[Dict[str, np.ndarray]] = None
    quarantined: List[dict] = []
    fault_events: List[dict] = []
    if resume:
        if store is None:
            raise ValueError("resume=True needs out_dir")
        man = store.load_manifest()
        if man is None:
            raise FileNotFoundError(
                f"resume=True but no manifest under {out_dir}")
        if man.get("grid_sha") != grid_sha or man.get("config") != config:
            raise ValueError(
                "resume manifest does not match this campaign (grid "
                "or config changed); start fresh in a new out_dir")
        acc_host, start_chunk, fault_events = \
            store.load_acc_checked(man)
        # quarantine entries at or past the resume point describe
        # chunks the resume recomputes — drop them like stale rows
        quarantined = [q for q in man.get("quarantined", [])
                       if q["chunk"] < start_chunk]
        rows = store.truncate_rows(start_chunk)

    run_kw = dict(seed=int(seed), n_bins=int(n_bins), sketch=bool(sketch),
                  shard=shard, superstep_backend=superstep_backend,
                  device=dev)
    t0 = time.perf_counter()
    try:
        if mode == "adaptive":
            result = _run_adaptive(grid, plan_fn, kind, n, c_size,
                                   n_chunks, padded, n_bins, k_top,
                                   run_kw, pinned, kernel_kw, steps_kw,
                                   pipeline_depth, checkpoint_every,
                                   store, config, grid_sha, start_chunk,
                                   rows, acc_host, stop_after_chunks,
                                   pilot, target_ci, refine_budget,
                                   n_max, safety, keep_point_stats)
        elif mode == "serial":
            result = _run_serial(grid, caps_fn, kind, n, c_size,
                                 n_chunks, padded, n_bins, k_top, run_kw,
                                 kernel_kw, store, config, grid_sha,
                                 start_chunk, rows, acc_host,
                                 stop_after_chunks)
        else:
            result = _run_pipelined(grid, plan_fn, kind, n, c_size,
                                    n_chunks, padded, n_bins, k_top,
                                    run_kw, pinned, kernel_kw,
                                    pipeline_depth, checkpoint_every,
                                    store, config, grid_sha,
                                    start_chunk, rows, acc_host,
                                    stop_after_chunks, metrics_tap,
                                    tap_every, fault_plan,
                                    fault_retries, fault_backoff_s,
                                    _kill_after_chunks, quarantined)
    finally:
        if store is not None:
            store.close()
    result.wall_s = time.perf_counter() - t0
    result.fault_events = fault_events + result.fault_events
    if store is not None:
        result.out_dir = str(store.dir)
    return result


def _chunk_grid(grid, start: int, c_size: int, n: int):
    idx = np.minimum(np.arange(start, start + c_size), n - 1)
    return grid.take(idx), min(c_size, n - start)


def _fold_inputs(out: Dict[str, Any], lam_dev, has_loss: bool,
                 has_sums: bool) -> Dict[str, Any]:
    chunk = {
        "hist": out["hist"], "n_jobs": out["n_jobs"],
        "dropped": out["dropped"],
        "batches": out.get("n_batches", out.get("n_steps")),
        "mean_latency": out["mean_latency"],
        "utilization": out["utilization"],
        "mean_batch": out["mean_batch"], "lam": lam_dev,
        "lat_bm_m2": out["lat_bm_m2"], "lat_bm_n": out["lat_bm_n"],
    }
    if has_sums:
        chunk["hist_sums"] = out["hist_sums"]
    if has_loss:
        for k in ("overflow_dropped", "abandoned", "n_in_slo",
                  "n_fresh", "n_retry"):
            chunk[k] = out[k]
    return chunk


def _limit_copy(hc: _HostCopies, out: Dict[str, Any]):
    """The run's ``"_limits"`` (popped from ``out``) and a host copy of
    their values, or ``(None, None)``."""
    limits = list(out.pop("_limits", {}).values())
    if not limits:
        return None, None
    vals = torch.stack([v.to(torch.int64) for v, _, _ in limits])
    return limits, hc.copy(vals)


def _run_pipelined(grid, plan_fn, kind, n, c_size, n_chunks, padded,
                   n_bins, k_top, run_kw, pinned, kernel_kw, depth,
                   checkpoint_every, store, config, grid_sha, start_chunk,
                   rows, acc_host, stop_after, metrics_tap, tap_every,
                   fault_plan, fault_retries, fault_backoff_s, kill_after,
                   quarantined):
    dev = run_kw["device"]
    hc = _HostCopies(dev)
    if acc_host is None:
        acc_host = _init_acc(n_bins, k_top)
    acc = FoldAcc.from_host(acc_host, dev)

    last_chunk = n_chunks if stop_after is None \
        else min(n_chunks, start_chunk + stop_after)
    pending = []       # (ci, summary|None, ckpt|None, limits, event, meta)
    peak_host = 0
    tapped = 0
    drained = 0
    has_loss = bool(grid.has_loss)

    meta_t0 = {}

    def drain_one():
        nonlocal peak_host, drained
        ci, summary_h, ckpt_h, (limits, lim_h), ev, meta = pending.pop(0)
        skip = meta.pop("_skip", None)
        hc.wait(ev)                                  # the chunk is done
        if limits is not None:
            _limits_check(lim_h.numpy(), limits)
        if summary_h is not None:
            summary = summary_dict(summary_h.numpy(), has_loss)
            summary_bytes = summary_h.numpy().nbytes
        else:
            # dispatch-quarantined chunk: nothing was folded
            summary = {"points": 0, "jobs": 0, "buffer_dropped": 0,
                       "quarantined": meta["points"]}
            summary_bytes = _nbytes(summary)
        host_bytes = summary_bytes + meta.pop("_grid_bytes")
        q_pts = int(summary.get("quarantined", 0))
        if q_pts:
            quarantined.append(
                {"chunk": ci, "points": q_pts,
                 "reason": "dispatch" if skip is not None
                 else "nonfinite",
                 **({"error": skip} if skip is not None else {})})
        acc_np = None
        if ckpt_h is not None:
            acc_np = acc.unpack(ckpt_h[0].numpy(), ckpt_h[1].numpy())
            host_bytes += _nbytes(acc_np)
        row = {"chunk": ci, **meta, **summary,
               "wall_s": round(time.perf_counter()
                               - meta_t0.pop(ci), 4),
               "host_bytes": host_bytes}
        if store is not None:
            store.append_row(row)
            if acc_np is not None:
                corrupt = (fault_plan is not None
                           and fault_plan.roll("corrupt", ci))
                store.checkpoint(
                    {"version": MANIFEST_VERSION, "grid_sha": grid_sha,
                     "config": config, "chunks_done": ci + 1,
                     "n_chunks": n_chunks, "mode": "pipelined",
                     "quarantined": [q for q in quarantined
                                     if q["chunk"] <= ci]},
                    acc_np, corrupt=corrupt)
        rows.append(row)
        peak_host = max(peak_host, host_bytes)
        if metrics_tap is not None:
            metrics_tap.observe_chunk(**{k: v for k, v in row.items()
                                         if k != "host_bytes"})
        drained += 1
        if kill_after is not None and drained >= kill_after:
            raise CampaignKilled(drained)

    def ckpt_copy():
        # on the stream, after this chunk's fold and before the next
        return hc.copy(acc.ints), hc.copy(acc.floats)

    for ci in range(start_chunk, last_chunk):
        start = ci * c_size
        cgrid, n_valid = _chunk_grid(grid, start, c_size, n)
        tap_this = (metrics_tap is not None and tap_every > 0
                    and ci % tap_every == 0)
        meta_t0[ci] = time.perf_counter()

        # bounded retry with exponential backoff around the dispatch;
        # the attempt number feeds the injection hash, so retries
        # re-roll instead of deterministically refailing
        attempt, skip, out, plan = 0, None, None, None
        while True:
            try:
                if fault_plan is not None and \
                        fault_plan.roll("dispatch", ci, attempt):
                    raise CampaignFault(
                        f"injected dispatch failure (chunk {ci}, "
                        f"attempt {attempt})")
                plan = plan_fn(cgrid, key_offset=start,
                               metrics_tap=(metrics_tap if tap_this
                                            else None),
                               **run_kw, **pinned, **kernel_kw)
                out = engine.dispatch_device(plan.kernel, plan.params,
                                             plan.keys)
                break
            except (CampaignFault, RuntimeError) as e:
                if attempt >= fault_retries:
                    skip = str(e)     # quarantine, never silently drop
                    break
                time.sleep(fault_backoff_s * (2.0 ** attempt))
                attempt += 1

        is_ckpt = (store is not None
                   and ((ci + 1) % max(checkpoint_every, 1) == 0
                        or ci == last_chunk - 1))
        if skip is not None:
            # the accumulator is untouched, but a due checkpoint
            # still advances chunks_done past the quarantined chunk
            ckpt_h = ckpt_copy() if is_ckpt else None
            pending.append((ci, None, ckpt_h, (None, None), hc.event(),
                            {"start": start, "points": n_valid,
                             "padded": c_size - n_valid,
                             "tapped": False, "retries": attempt,
                             "_skip": skip, "_grid_bytes": 0}))
            while len(pending) > max(depth, 1):
                drain_one()
            continue

        tapped += bool(tap_this)
        poison = (fault_plan is not None
                  and fault_plan.roll("nan", ci, attempt))
        limits = _limit_copy(hc, out)
        chunk = _fold_inputs(out, plan.params["lam"], plan.has_loss,
                             plan.sketch)
        if poison:
            # injected kernel pathology: every float statistic of the
            # chunk turns NaN; the fold guard must quarantine the
            # points, not the campaign
            chunk["mean_latency"] = chunk["mean_latency"] + float("nan")
        gidx = torch.arange(start, start + c_size, dtype=torch.int64,
                            device=dev)
        summary = campaign_fold(acc, chunk, gidx, n_valid,
                                has_loss=plan.has_loss, sketch=plan.sketch)
        summary_h = hc.copy(summary)
        ckpt_h = ckpt_copy() if is_ckpt else None
        del out, chunk
        pending.append((ci, summary_h, ckpt_h, limits, hc.event(),
                        {"start": start, "points": n_valid,
                         "padded": c_size - n_valid,
                         "tapped": bool(tap_this),
                         "retries": attempt,
                         "_grid_bytes": _nbytes(cgrid._arrays())}))
        while len(pending) > max(depth, 1):
            drain_one()
    while pending:
        drain_one()

    completed = last_chunk == n_chunks
    return CampaignResult(
        kind=kind, mode="pipelined", n_points=n, n_chunks=n_chunks,
        chunk_size=c_size, padded_points=padded, completed=completed,
        sketch=bool(run_kw["sketch"]), acc=acc.to_host(), rows=rows,
        peak_host_result_bytes=peak_host, tapped_chunks=tapped,
        quarantined_chunks=quarantined)


def _refine_schedule(alloc: np.ndarray, c_size: int):
    """Deterministic final-pass schedule from a per-point cycle
    allocation: tiers ascending, global point index ascending within a
    tier, each tier cut into fixed-width chunks (tail padded by
    repeating the last index, masked out of the fold).  Returns
    ``[(tier_cycles, gidx[c_size], n_valid), ...]``.  With a uniform
    allocation this degenerates to contiguous global-order chunks —
    the same fold sequence as ``mode="pipelined"``."""
    chunks = []
    for tier in np.unique(alloc):
        gsel = np.flatnonzero(alloc == tier).astype(np.int64)
        for off in range(0, gsel.size, c_size):
            part = gsel[off:off + c_size]
            nv = int(part.size)
            if nv < c_size:
                part = np.concatenate(
                    [part, np.repeat(part[-1:], c_size - nv)])
            chunks.append((int(tier), part, nv))
    return chunks


def _run_adaptive(grid, plan_fn, kind, n, c_size, n_chunks, padded,
                  n_bins, k_top, run_kw, pinned, kernel_kw, steps_kw,
                  depth, checkpoint_every, store, config, grid_sha,
                  start_chunk, rows, acc_host, stop_after,
                  pilot, target_ci, refine_budget, n_max, safety,
                  keep_point_stats):
    """Convergence-aware scheduler: pilot triage (no fold, small host
    copies), Neyman/target allocation snapped to pow2-of-pilot tiers,
    then a pipelined final pass over compacted fixed-shape chunks that
    re-runs EVERY point at its allocated cycle count with its own key.
    Global chunk numbering: pilot chunks are ``0..n_chunks-1``,
    final-pass chunks follow; checkpoints only exist from the
    pilot-complete boundary (``chunks_done == n_chunks``) onward, so a
    resume always lands in the final pass with the persisted
    ``triage.npz`` as its basis."""
    dev = run_kw["device"]
    hc = _HostCopies(dev)
    base_kw = {k: v for k, v in kernel_kw.items() if k != steps_kw}
    peak_host = 0
    has_loss = bool(grid.has_loss)

    # ---- phase 1: pilot triage --------------------------------------
    triage = None
    if store is not None and start_chunk >= n_chunks:
        with np.load(store.dir / "triage.npz") as z:
            triage = {k: np.asarray(z[k]) for k in z.files}
    if triage is None:
        m2 = np.zeros(n, np.float64)
        nb = np.zeros(n, np.int64)
        jobs = np.zeros(n, np.int64)
        drop = np.zeros(n, np.int64)
        mean = np.zeros(n, np.float64)
        pending = []

        def drain_pilot():
            nonlocal peak_host
            ci_, small_h, (limits, lim_h), ev, meta = pending.pop(0)
            hc.wait(ev)                          # the chunk is done
            if limits is not None:
                _limits_check(lim_h.numpy(), limits)
            small = {k: v.numpy() for k, v in small_h.items()}
            host_bytes = _nbytes(small) + meta["grid_bytes"]
            nv, start = meta["points"], meta["start"]
            sl, seg = slice(0, nv), slice(start, start + nv)
            m2[seg] = small["m2"][sl]
            nb[seg] = small["nb"][sl]
            jobs[seg] = small["jobs"][sl]
            drop[seg] = small["drop"][sl]
            mean[seg] = small["mean"][sl]
            row = {"chunk": ci_, "phase": "pilot", "start": start,
                   "points": nv, "padded": meta["padded"],
                   "tapped": False,
                   "jobs": int(small["jobs"][sl].sum()),
                   "buffer_dropped": int(small["drop"][sl].sum()),
                   "wall_s": round(time.perf_counter() - meta["t0"],
                                   4),
                   "host_bytes": host_bytes}
            rows.append(row)
            if store is not None:
                store.append_row(row)
            peak_host = max(peak_host, host_bytes)

        for ci_ in range(n_chunks):
            start = ci_ * c_size
            cgrid, n_valid = _chunk_grid(grid, start, c_size, n)
            t0 = time.perf_counter()
            plan = plan_fn(cgrid, key_offset=start, **run_kw, **pinned,
                           **base_kw, **{steps_kw: pilot})
            out = engine.dispatch_device(plan.kernel, plan.params,
                                         plan.keys)
            limits = _limit_copy(hc, out)
            small_h = {k: hc.copy(out[src]) for k, src in (
                ("m2", "lat_bm_m2"), ("nb", "lat_bm_n"),
                ("jobs", "n_jobs"), ("drop", "dropped"),
                ("mean", "mean_latency"))}
            del out
            pending.append((ci_, small_h, limits, hc.event(),
                            {"start": start, "points": n_valid,
                             "padded": c_size - n_valid,
                             "t0": t0,
                             "grid_bytes": _nbytes(cgrid._arrays())}))
            while len(pending) > max(depth, 1):
                drain_pilot()
        while pending:
            drain_pilot()

        _, ci_hw = batch_means_stats(m2, nb)
        alloc = allocate_cycles(ci_hw, pilot, n_max=n_max,
                                target_ci=target_ci,
                                refine_budget=refine_budget,
                                safety=safety)
        # allocate_cycles returns pow2-of-pilot tiers capped at n_max,
        # so there are at most log2(n_max/pilot)+2 tiers
        triage = {"alloc": alloc.astype(np.int64),
                  "pilot_ci": ci_hw, "pilot_mean": mean,
                  "pilot_jobs": jobs, "pilot_dropped": drop}
        if store is not None:
            buf = io.BytesIO()
            np.savez(buf, **triage)
            _atomic_write(store.dir / "triage.npz", buf.getvalue())

    fchunks = _refine_schedule(triage["alloc"], c_size)
    n_total = n_chunks + len(fchunks)
    pilot_jobs = int(triage["pilot_jobs"].sum())

    def manifest(done):
        return {"version": MANIFEST_VERSION, "grid_sha": grid_sha,
                "config": config, "chunks_done": done,
                "n_chunks": n_total, "mode": "adaptive",
                "pilot_chunks": n_chunks}

    if acc_host is None:
        acc_host = _init_acc(n_bins, k_top)
    if store is not None and start_chunk < n_chunks:
        # pilot-complete boundary: persist the (still empty)
        # accumulator + triage so a resume skips the pilot entirely
        store.checkpoint(manifest(n_chunks), acc_host)
        start_chunk = n_chunks

    stats = {"alloc": triage["alloc"], "pilot_ci": triage["pilot_ci"],
             "pilot_mean": triage["pilot_mean"]}
    if keep_point_stats:
        stats["mean_latency"] = np.full(n, np.nan)
        stats["ci_halfwidth"] = np.full(n, np.nan)
        stats["n_jobs"] = np.zeros(n, np.int64)

    # ---- phase 2: compacted, tiered final pass (the only fold) ------
    acc = FoldAcc.from_host(acc_host, dev)
    f_start = max(start_chunk - n_chunks, 0)
    last_f = len(fchunks) if stop_after is None \
        else min(len(fchunks), f_start + stop_after)
    pending = []

    def drain_final():
        nonlocal peak_host
        (gci, summary_h, ckpt_h, refs_h, (limits, lim_h), ev, gsel, meta,
         t0c, gbytes) = pending.pop(0)
        hc.wait(ev)                              # the chunk is done
        if limits is not None:
            _limits_check(lim_h.numpy(), limits)
        summary = summary_dict(summary_h.numpy(), has_loss)
        host_bytes = summary_h.numpy().nbytes + gbytes
        if refs_h is not None:
            small = {k: v.numpy() for k, v in refs_h.items()}
            host_bytes += _nbytes(small)
            nv = meta["points"]
            sl = slice(0, nv)
            _, cihw = batch_means_stats(
                np.asarray(small["m2"][sl], np.float64),
                np.asarray(small["nb"][sl]))
            stats["mean_latency"][gsel[:nv]] = small["mean"][sl]
            stats["ci_halfwidth"][gsel[:nv]] = cihw
            stats["n_jobs"][gsel[:nv]] = small["jobs"][sl]
        acc_np = None
        if ckpt_h is not None:
            acc_np = acc.unpack(ckpt_h[0].numpy(), ckpt_h[1].numpy())
            host_bytes += _nbytes(acc_np)
        row = {"chunk": gci, "phase": "refine", **meta, **summary,
               "wall_s": round(time.perf_counter() - t0c, 4),
               "host_bytes": host_bytes}
        rows.append(row)
        if store is not None:
            store.append_row(row)
            if acc_np is not None:
                store.checkpoint(manifest(gci + 1), acc_np)
        peak_host = max(peak_host, host_bytes)

    for fi in range(f_start, last_f):
        tier, gsel, n_valid = fchunks[fi]
        gci = n_chunks + fi
        cgrid = grid.take(gsel)
        t0c = time.perf_counter()
        plan = plan_fn(cgrid, key_offset=0, **run_kw, **pinned,
                       **base_kw, **{steps_kw: int(tier)})
        # the determinism contract: replace the plan's contiguous keys
        # with the SAME per-point keys every schedule uses
        gidx = torch.as_tensor(gsel, dtype=torch.int64, device=dev)
        plan = plan._replace(keys=prng.point_keys_at(int(run_kw["seed"]),
                                                     gidx))
        out = engine.dispatch_device(plan.kernel, plan.params, plan.keys)
        limits = _limit_copy(hc, out)
        chunk = _fold_inputs(out, plan.params["lam"], plan.has_loss,
                             plan.sketch)
        summary = campaign_fold(acc, chunk, gidx, n_valid,
                                has_loss=plan.has_loss, sketch=plan.sketch)
        summary_h = hc.copy(summary)
        refs_h = None
        if keep_point_stats:
            refs_h = {k: hc.copy(out[src]) for k, src in (
                ("m2", "lat_bm_m2"), ("nb", "lat_bm_n"),
                ("jobs", "n_jobs"), ("mean", "mean_latency"))}
        is_ckpt = (store is not None
                   and ((fi + 1) % max(checkpoint_every, 1) == 0
                        or fi == last_f - 1))
        ckpt_h = (hc.copy(acc.ints), hc.copy(acc.floats)) if is_ckpt \
            else None
        del out, chunk
        pending.append((gci, summary_h, ckpt_h, refs_h, limits, hc.event(),
                        gsel,
                        {"start": int(gsel[0]), "tier": tier,
                         "points": n_valid,
                         "padded": c_size - n_valid,
                         "tapped": False},
                        t0c, _nbytes(cgrid._arrays())))
        while len(pending) > max(depth, 1):
            drain_final()
    while pending:
        drain_final()

    return CampaignResult(
        kind=kind, mode="adaptive", n_points=n, n_chunks=n_total,
        chunk_size=c_size, padded_points=padded,
        completed=last_f == len(fchunks), sketch=bool(run_kw["sketch"]),
        acc=acc.to_host(), rows=rows, peak_host_result_bytes=peak_host,
        pilot_jobs=pilot_jobs, point_stats=stats)


def _run_serial(grid, caps_fn, kind, n, c_size, n_chunks, padded, n_bins,
                k_top, run_kw, kernel_kw, store, config, grid_sha,
                start_chunk, rows, acc_host, stop_after):
    """The pre-campaign workflow, as a measurable baseline: a blocking
    per-chunk loop through the sweep's result path (full per-point
    host materialisation) with per-chunk caps — each chunk sized from
    its own grid — and a host-side numpy reduction."""
    from repro_torch.core.fleet import fleet_sweep
    from repro_torch.core.gen_sweep import gen_sweep
    from repro_torch.core.sweep import sweep

    run = {"sweep": sweep, "fleet": fleet_sweep, "gen": gen_sweep}[kind]
    acc = acc_host if acc_host is not None else _init_acc(n_bins, k_top)
    peak_host = 0
    shapes = set()
    last_chunk = n_chunks if stop_after is None \
        else min(n_chunks, start_chunk + stop_after)
    for ci in range(start_chunk, last_chunk):
        start = ci * c_size
        cgrid, n_valid = _chunk_grid(grid, start, c_size, n)
        t0 = time.perf_counter()
        chunk_caps = caps_fn(cgrid)
        shapes.add(tuple(sorted(chunk_caps.items())))
        r = run(cgrid, key_offset=start, **run_kw, **chunk_caps,
                **kernel_kw)
        host_bytes = (_nbytes([r.hist]) + _nbytes(cgrid._arrays())
                      + _nbytes([r.mean_latency, r.n_jobs,
                                 r.utilization, r.mean_batch]))
        _host_fold(acc, r, start, n_valid, k_top)
        row = {"chunk": ci, "start": start, "points": n_valid,
               "padded": c_size - n_valid, "tapped": False,
               "jobs": int(r.n_jobs[:n_valid].sum()),
               "buffer_dropped": int(r.buffer_dropped[:n_valid].sum()),
               "wall_s": round(time.perf_counter() - t0, 4),
               "host_bytes": host_bytes}
        rows.append(row)
        if store is not None:
            store.append_row(dict(row))
            store.checkpoint(
                {"version": MANIFEST_VERSION, "grid_sha": grid_sha,
                 "config": config, "chunks_done": ci + 1,
                 "n_chunks": n_chunks, "mode": "serial"}, acc)
        peak_host = max(peak_host, host_bytes)
    return CampaignResult(
        kind=kind, mode="serial", n_points=n, n_chunks=n_chunks,
        chunk_size=c_size, padded_points=padded,
        completed=last_chunk == n_chunks, sketch=bool(run_kw["sketch"]),
        acc=acc, rows=rows, peak_host_result_bytes=peak_host,
        serial_compile_shapes=len(shapes))


def _host_fold(acc: Dict[str, np.ndarray], r, start: int, n_valid: int,
               k_top: int) -> None:
    """Numpy mirror of the device fold (vectorized — serial results
    are a statistical baseline, not part of the bitwise contract).
    Applies the same non-finite quarantine guard as the device fold:
    poisoned points are masked out of every sum and counted."""
    sl = slice(0, n_valid)
    fin = (np.isfinite(r.mean_latency[sl])
           & np.isfinite(r.utilization[sl])
           & np.isfinite(r.mean_batch[sl]))
    if not fin.all():
        acc["quarantined_points"] = (acc["quarantined_points"]
                                     + np.int64((~fin).sum()))
    finc = fin.astype(np.int64)
    acc["hist"] = acc["hist"] + (r.hist[sl]
                                 * finc[:, None]).sum(0).astype(np.int64)
    if r.hist_sums is not None:
        acc["hist_sums"] = (acc["hist_sums"]
                            + np.where(fin[:, None], r.hist_sums[sl],
                                       0.0).sum(0).astype(np.float64))
    jobs = r.n_jobs[sl].astype(np.int64) * finc
    acc["points"] = acc["points"] + np.int64(int(fin.sum()))
    acc["jobs"] = acc["jobs"] + jobs.sum()
    batches = getattr(r, "n_batches", None)
    if batches is None:
        batches = r.n_steps
    acc["batches"] = (acc["batches"]
                      + (batches[sl].astype(np.int64) * finc).sum())
    acc["buffer_dropped"] = (acc["buffer_dropped"]
                             + (r.buffer_dropped[sl].astype(np.int64)
                                * finc).sum())
    for k in ("overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
              "n_retry"):
        acc[k] = acc[k] + (getattr(r, k)[sl].astype(np.int64)
                           * finc).sum()
    lat = np.where(fin, r.mean_latency[sl].astype(np.float64), 0.0)
    acc["sum_latency_jobs"] = (acc["sum_latency_jobs"]
                               + (lat * jobs).sum())
    acc["sum_latency"] = acc["sum_latency"] + lat.sum()
    acc["sum_util"] = (acc["sum_util"]
                       + np.where(fin, r.utilization[sl]
                                  .astype(np.float64), 0.0).sum())
    acc["sum_batch"] = (acc["sum_batch"]
                        + np.where(fin, r.mean_batch[sl]
                                   .astype(np.float64), 0.0).sum())
    ci = getattr(r, "ci_halfwidth", None)
    if ci is not None:
        ci = np.nan_to_num(ci[sl].astype(np.float64), nan=0.0,
                           posinf=0.0)
        if ci.size:
            acc["max_ci"] = np.maximum(acc["max_ci"], ci.max())
    gidx = np.arange(start, start + n_valid, dtype=np.int64)
    offered = (jobs + r.overflow_dropped[sl] + r.abandoned[sl])
    gfrac = np.where(offered > 0,
                     r.n_in_slo[sl] / np.maximum(offered, 1), 1.0)
    for vkey, ikey, vals in (
            ("top_lat_val", "top_lat_idx", np.where(fin, lat, -np.inf)),
            ("top_good_val", "top_good_idx",
             np.where(fin, r.grid.lam[sl].astype(np.float64) * gfrac,
                      -np.inf))):
        allv = np.concatenate([acc[vkey], vals])
        alli = np.concatenate([acc[ikey], gidx])
        order = np.lexsort((alli, -allv))[:k_top]
        acc[vkey], acc[ikey] = allv[order], alli[order]


# ---------------------------------------------------------------------------
# the resume-parity witness
# ---------------------------------------------------------------------------

def verify_resume(grid, *, out_dir, kill_after_chunks: int,
                  **campaign_kw) -> dict:
    """Kill a campaign mid-flight, resume it, and PROVE the result.

    Runs the campaign three ways: an uninterrupted in-memory
    reference, a checkpointing run hard-killed (``CampaignKilled``)
    after ``kill_after_chunks`` drained chunks, and a ``resume=True``
    continuation from whatever the kill left on disk.  Asserts the
    resumed fingerprint is BITWISE equal to the reference — under any
    ``fault_plan`` faults too, since the injection schedule is a pure
    function of (seed, kind, chunk, attempt) and replays identically.

    Returns a witness dict (fingerprint, kill/resume chunk indices,
    fault events seen on resume, quarantined chunks).  Raises
    ``AssertionError`` on a parity violation and ``ValueError`` when
    the kill never fired (``kill_after_chunks`` past the last chunk).
    """
    for k in ("out_dir", "resume", "_kill_after_chunks",
              "stop_after_chunks"):
        if k in campaign_kw:
            raise ValueError(f"verify_resume controls {k!r} itself")
    ref = campaign(grid, **campaign_kw)
    killed_at = None
    try:
        campaign(grid, out_dir=out_dir,
                 _kill_after_chunks=kill_after_chunks, **campaign_kw)
    except CampaignKilled as e:
        killed_at = e.chunks_drained
    if killed_at is None:
        raise ValueError(
            f"kill_after_chunks={kill_after_chunks} never fired — the "
            f"campaign has only {ref.n_chunks} chunks")
    man = _Store(Path(out_dir)).load_manifest()
    resumed_from = int(man["chunks_done"]) if man else 0
    resumed = campaign(grid, out_dir=out_dir, resume=True,
                       **campaign_kw)
    if not resumed.completed:
        raise AssertionError("resumed campaign did not complete")
    fp_ref, fp_res = ref.fingerprint(), resumed.fingerprint()
    if fp_ref != fp_res:
        raise AssertionError(
            f"resume parity violated: uninterrupted {fp_ref[:16]} != "
            f"killed-and-resumed {fp_res[:16]} (killed after "
            f"{killed_at} chunks, resumed from chunk {resumed_from})")
    return {"match": True, "fingerprint": fp_ref,
            "killed_after": int(killed_at),
            "resumed_from": resumed_from,
            "replayed_chunks": ref.n_chunks - resumed_from,
            "fault_events": resumed.fault_events,
            "quarantined_chunks": resumed.quarantined_chunks}
