"""The port's dispatch over several devices (``core.engine``), on the CPU.

- ``resolve_shards`` counts devices as the reference's
  ``repro.core.engine.resolve_shards`` does (this host's JAX sees one CPU
  device, as the port's CPU route does), raises below 1, and with two
  CUDA devices visible (``torch.cuda.device_count`` monkeypatched) gives
  ``shard=None`` and ``shard=2`` the list ``[cuda:0, cuda:1]`` without
  running anything; a plan records that list.
- ``sweep``, ``gen_sweep``, ``fleet_sweep`` and ``campaign`` (pipelined,
  serial and adaptive) over the private device list ``[cpu] × k``
  (``engine._over_devices``: k slices on one CPU, one after another in
  this process, or with ``workers=True`` the slices past the first in a
  spawned worker process, as a further GPU's run), at k = 2 and 3 on
  grids whose point counts k does not divide, are bitwise equal to
  ``shard=1``.  The mixed grids put loss-free, loss and failure
  points in runs of their own, so that a slice holds a single regime and
  must still run the whole grid's code (its caps and grid-wide flags).
- ``shard=None`` takes every device in ``sweep`` and one in
  ``fleet_sweep``, ``gen_sweep`` and ``campaign``; a metrics tap runs on
  one device.
- A worker process that dies is replaced once; a second death raises
  ``WorkerLost``, which the campaign's dispatch retry lets through.
"""
import functools
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro_torch.core import engine, fleet_sweep, gen_sweep, sweep
from repro_torch.core.campaign import campaign
from repro_torch.core.fleet import fleet_plan
from repro_torch.core.gen_sweep import gen_plan
from repro_torch.core.grid import FleetGrid, GenGrid, SweepGrid
from repro_torch.core.metrics import MetricsTap
from repro_torch.core.sweep import sweep_plan

CPU = dict(device="cpu")
ALPHA, TAU0 = 0.1438, 1.8874
CPUS = torch.device("cpu")


def _regimes(n, loss, fail):
    """Per-point masks: loss-free points first, then loss, then failure
    points, in runs."""
    i = np.arange(n)
    return (i >= loss) & (i < fail), i >= fail


def _sweep_grid(n=7, cls=SweepGrid, **extra):
    """n points: [0, 3) loss-free, [3, 5) with a room, a deadline and a
    retry orbit, [5, n) failing (resume, restart, drop in turn)."""
    lossy, failing = _regimes(n, 3, 5)
    i = np.arange(n)
    b = np.where(i % 2 == 0, 4, 8).astype(np.int32)
    lam = np.linspace(0.3, 0.8, n).astype(np.float32) * b / (ALPHA * b
                                                             + TAU0)
    return cls.from_points(
        lam, ALPHA, TAU0, b_max=b,
        dist=np.where(i % 3 == 1, 1, 0).astype(np.int32),
        q_max=np.where(lossy, 16, 0).astype(np.int32),
        deadline=np.where(lossy & (i % 2 == 1), 60.0, 0.0).astype(np.float32),
        retry_rate=np.where(lossy, 0.25, 0.0).astype(np.float32),
        mtbf=np.where(failing, 400.0, 0.0).astype(np.float32),
        mttr=np.where(failing, 5.0, 0.0).astype(np.float32),
        fail_disc=np.array(["resume", "restart", "drop"])[i % 3], **extra)


def _gen_grid(n=7):
    lossy, failing = _regimes(n, 3, 5)
    i = np.arange(n)
    return GenGrid.from_points(
        np.linspace(0.05, 0.25, n, dtype=np.float32), 0.02, 0.5, 0.01, 2.0,
        prompt_len=32, gen_tokens=8, max_active=np.where(i % 2, 8, 16),
        q_max=np.where(lossy, 16, 0).astype(np.int32),
        retry_rate=np.where(lossy, 0.2, 0.0).astype(np.float32),
        mtbf=np.where(failing, 2000.0, 0.0).astype(np.float32),
        mttr=np.where(failing, 5.0, 0.0).astype(np.float32),
        discipline=np.array(["continuous", "static"])[i % 2])


def _fleet_grid(n=7):
    i = np.arange(n)
    routes = np.array(["jsq", "random", "round_robin"])
    return _sweep_grid(n, cls=FleetGrid, k=np.array([1, 2, 4])[i % 3],
                       routing=routes[i % 3])


ENTRIES = {
    "sweep": (sweep, _sweep_grid, dict(n_batches=64)),
    "gen_sweep": (gen_sweep, _gen_grid, dict(n_steps=64)),
    "fleet_sweep": (fleet_sweep, _fleet_grid, dict(n_steps=64)),
}


def _same(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y,
                                                         equal_nan=True), f


# ---------------------------------------------------------------------------
# resolve_shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [None, True, False, 1, 2, 5])
@pytest.mark.parametrize("n_points", [1, 3, 64])
def test_resolve_shards_counts_as_the_reference(shard, n_points):
    got = engine.resolve_shards(shard, n_points, "cpu")
    assert len(got) == ref_engine.resolve_shards(shard, n_points)
    assert got == [CPUS]


def test_resolve_shards_below_one_raises():
    with pytest.raises(ValueError, match="shard must be >= 1"):
        ref_engine.resolve_shards(0, 8)
    with pytest.raises(ValueError, match="shard must be >= 1"):
        engine.resolve_shards(0, 8, "cpu")
    g = _sweep_grid()
    for entry in (sweep, gen_sweep, fleet_sweep, campaign):
        grid = {gen_sweep: _gen_grid(), fleet_sweep: _fleet_grid()}.get(
            entry, g)
        with pytest.raises(ValueError, match="shard must be >= 1"):
            entry(grid, shard=0, **CPU)


def test_two_visible_gpus_resolve_to_both_without_a_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    both = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for shard in (None, True, 2, 3):
        assert engine.resolve_shards(shard, 16, "cuda") == both
    assert engine.resolve_shards(2, 1, "cuda") == [torch.device("cuda")]
    assert engine.resolve_shards(False, 16, "cuda") == [torch.device("cuda")]
    assert engine.resolve_shards(None, 16, "cpu") == [CPUS]
    # a plan records the list and runs nothing: the grid is validated and
    # the caps sized on the host, the keys made on the plan's device
    plan = sweep_plan(_sweep_grid(), n_batches=64, shard=None, **CPU)
    assert plan.devices == [CPUS]
    assert engine.plan_devices(None, 16, "cuda") == both
    assert engine.plan_devices(None, 16, "cuda",
                               tap=object()) == [torch.device("cuda")]


# ---------------------------------------------------------------------------
# the three sweeps over [cpu] x k
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one(entry):
    """The entry point's run on one device (``shard=1``), once."""
    fn, grid_fn, kw = ENTRIES[entry]
    return fn(grid_fn(), seed=5, shard=1, **kw, **CPU)


@pytest.mark.parametrize("workers", [False, True])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_sweeps_over_cpu_slices_are_bitwise_one_dispatch(entry, k, workers):
    fn, grid_fn, kw = ENTRIES[entry]
    g = grid_fn()
    assert len(g) % k and g.has_loss and g.has_fail
    with engine._over_devices([CPUS] * k, workers=workers):
        split = fn(g, seed=5, **kw, **CPU)
    _same(_one(entry), split)
    assert int(split.buffer_dropped.sum()) == 0


@pytest.mark.parametrize("plan_fn, grid_fn", [
    (sweep_plan, _sweep_grid), (gen_plan, _gen_grid),
    (fleet_plan, _fleet_grid)])
def test_a_slice_of_one_regime_runs_the_whole_grids_code(plan_fn, grid_fn):
    """At k = 3 the 7-point grid's slices hold its loss-free, loss and
    failure points apart (the failing slice's drop point makes it a loss
    grid too); every slice returns the whole grid's output
    schema and shapes, and its points the bits of the one-device
    run."""
    g = grid_fn()
    kw = dict(n_steps=64) if plan_fn is not sweep_plan else dict(
        n_batches=64)
    with engine._over_devices([CPUS] * 3):
        plan = plan_fn(g, seed=5, **kw, **CPU)
    assert plan.devices == [CPUS] * 3
    whole = plan.kernel(plan.keys)
    parts = []
    for lo, hi in ((0, 3), (3, 5), (5, 7)):
        sub = g.take(slice(lo, hi))
        # the first slice holds loss-free points only
        assert lo or not (sub.has_loss or sub.has_fail)
        part = plan.kernel(tuple(t[lo:hi] for t in plan.keys),
                           slice(lo, hi), CPUS)
        assert set(part) == set(whole)
        for name, v in part.items():
            if name == "_limits":
                continue
            assert torch.equal(v, whole[name][lo:hi]), (name, lo)
        parts.append(part)
    # the gather: every output in point order; the generate sweep's
    # buffer reach (its one "_limits" entry) the max over the slices
    got = engine._gather(parts, CPUS)
    for name, v in whole.items():
        if name != "_limits":
            assert torch.equal(got[name], v), name
    assert ("_limits" in got) == (plan_fn is gen_plan)
    for key, (val, bound, msg) in whole.get("_limits", {}).items():
        assert int(got["_limits"][key][0]) == int(val)
        assert got["_limits"][key][1:] == (bound, msg)


# ---------------------------------------------------------------------------
# the campaign over [cpu] x k
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_campaign(entry, mode):
    _, grid_fn, kw = ENTRIES[entry]
    return campaign(grid_fn(CAMPAIGN_POINTS[entry]), chunk_size=8,
                    mode=mode, seed=7, shard=1, **kw, **CPU)


# two chunks of 8 for the sweeps; one short chunk for the generate
# sweep, whose 2,048-step host loop each slice runs again on the CPU
CAMPAIGN_POINTS = {"sweep": 11, "fleet_sweep": 11, "gen_sweep": 5}


@pytest.mark.parametrize("entry, mode, k, workers", [
    (entry, mode, k, k == 3) for entry in ENTRIES for k in (2, 3)
    for mode in (("pipelined", "serial") if entry == "sweep"
                 else ("pipelined",))])
def test_campaign_over_cpu_slices_is_bitwise_one_dispatch(entry, mode, k,
                                                          workers):
    _, grid_fn, kw = ENTRIES[entry]
    g = grid_fn(CAMPAIGN_POINTS[entry])
    with engine._over_devices([CPUS] * k, workers=workers):
        split = campaign(g, chunk_size=8, mode=mode, seed=7, **kw, **CPU)
    one = _one_campaign(entry, mode)
    assert split.fingerprint() == one.fingerprint()
    assert split.totals == one.totals


def test_adaptive_campaign_over_two_cpu_slices_is_bitwise():
    g = _sweep_grid(13)
    kw = dict(chunk_size=8, mode="adaptive", n_batches=256, pilot=64,
              target_ci=0.5, safety=4.0, seed=11, keep_point_stats=True,
              **CPU)
    one = campaign(g, shard=1, **kw)
    with engine._over_devices([CPUS] * 2, workers=True):
        split = campaign(g, **kw)
    assert split.fingerprint() == one.fingerprint()
    assert np.array_equal(split.point_stats["alloc"],
                          one.point_stats["alloc"])
    assert one.point_stats["alloc"].max() > 64


def test_a_metrics_tap_runs_on_one_device():
    g = _sweep_grid()
    with engine._over_devices([CPUS] * 3):
        tapped = sweep_plan(g, n_batches=64, metrics_tap=MetricsTap(), **CPU)
        plain = sweep_plan(g, n_batches=64, **CPU)
    assert tapped.devices == [CPUS] and plain.devices == [CPUS] * 3
    tap = MetricsTap(expected_points=len(g))
    with engine._over_devices([CPUS] * 3):
        r = sweep(g, n_batches=64, seed=5, metrics_tap=tap, **CPU)
    _same(sweep(g, n_batches=64, seed=5, **CPU), r)
    assert tap.supersteps == 2


def test_worker_slices_send_back_their_launches(monkeypatch):
    """A worker's launches are added to this process's counters (on the
    CPU route nothing launches, so a stubbed kernel counts)."""
    from repro_torch.kernels import superstep as ss
    counted = []

    def worker_run(kernel, keys, device):
        counted.append(device)
        out = kernel(keys, None, torch.device(device))
        return out, {"hist_update": 3, "fifo_compact": 0}

    class Pool:
        def submit(self, fn, *args):
            class Done:
                def result(self):
                    return worker_run(*args)
            return Done()

    monkeypatch.setattr(engine, "_worker", lambda device: Pool())
    g = _sweep_grid()
    # the stub's counts are undone after the test: other tests of this
    # process read the counter from zero
    monkeypatch.setattr(ss.hist_update, "launches", 0)
    with engine._over_devices([CPUS] * 3, workers=True):
        plan = sweep_plan(g, n_batches=64, seed=5, **CPU)
        got = engine.dispatch_device(plan)
    assert counted == ["cpu", "cpu"]
    assert ss.hist_update.launches == 6
    whole = plan.kernel(plan.keys)
    assert all(torch.equal(got[k], whole[k]) for k in whole)


# ---------------------------------------------------------------------------
# the default device count of each entry point
# ---------------------------------------------------------------------------

def test_the_default_spreads_the_sweep_alone(monkeypatch):
    """``shard=None`` reaches ``plan_devices`` as ``None`` (every visible
    device) from ``sweep``, and as 1 from ``fleet_sweep``, ``gen_sweep``
    and every chunk of a campaign; an explicit ``shard`` reaches it
    unchanged."""
    seen = []
    plan_devices = engine.plan_devices

    def record(shard, n_points, device, tap=None):
        seen.append(shard)
        return plan_devices(shard, n_points, device, tap)

    monkeypatch.setattr(engine, "plan_devices", record)
    for plan_fn, grid_fn in ((sweep_plan, _sweep_grid),
                             (fleet_plan, _fleet_grid),
                             (gen_plan, _gen_grid)):
        kw = dict(n_batches=64) if plan_fn is sweep_plan else dict(
            n_steps=64)
        for shard in (None, True, 2):
            seen.clear()
            plan_fn(grid_fn(), shard=shard, **kw, **CPU)
            want = 1 if shard is None and plan_fn is not sweep_plan \
                else shard
            assert seen == [want], (plan_fn.__name__, shard)
    for shard, want in ((None, 1), (True, True), (3, 3)):
        seen.clear()
        campaign(_sweep_grid(11), chunk_size=8, n_batches=64, seed=7,
                 shard=shard, **CPU)
        assert seen == [want, want]


# ---------------------------------------------------------------------------
# a worker process that dies
# ---------------------------------------------------------------------------

def _die_in_worker(grid, keys, device=None, fn=None, marker=None, **cfg):
    """A slice kernel that kills its worker process (at every call, or
    only while ``marker`` does not exist yet, which it then makes), and
    runs ``fn`` in the test's own process."""
    if multiprocessing.parent_process() is not None:
        if marker is None or not os.path.exists(marker):
            if marker is not None:
                open(marker, "w").close()
            os._exit(3)
    return fn(grid, keys, device=device, **cfg)


def _dying_plan(marker=None):
    """A sweep plan over [cpu] × 2, its second slice in a worker, whose
    kernel kills that worker."""
    with engine._over_devices([CPUS] * 2, workers=True):
        plan = sweep_plan(_sweep_grid(), n_batches=64, seed=5, **CPU)
    k = plan.kernel
    return plan, plan._replace(kernel=engine.SliceKernel(
        _die_in_worker, k.grid, dict(k.cfg, fn=k.fn, marker=marker),
        k.device))


def test_a_worker_that_dies_once_is_replaced(tmp_path):
    plan, dying = _dying_plan(str(tmp_path / "died"))
    with engine._over_devices([CPUS] * 2, workers=True):
        got = engine.dispatch_device(dying)
    assert (tmp_path / "died").exists()
    whole = plan.kernel(plan.keys)
    assert all(torch.equal(got[k], whole[k]) for k in whole)


def test_a_worker_that_dies_twice_raises_worker_lost():
    plan, dying = _dying_plan()
    assert not issubclass(engine.WorkerLost, RuntimeError)
    with engine._over_devices([CPUS] * 2, workers=True):
        with pytest.raises(engine.WorkerLost, match="died twice"):
            engine.dispatch_device(dying)
        # the next dispatch spawns a fresh worker
        got = engine.dispatch_device(plan)
    whole = plan.kernel(plan.keys)
    assert all(torch.equal(got[k], whole[k]) for k in whole)


def test_the_campaign_lets_a_lost_worker_through(monkeypatch):
    """``WorkerLost`` escapes the campaign's dispatch retry, which would
    run the chunk again and then quarantine it."""
    calls = []

    def lost(plan):
        calls.append(plan)
        raise engine.WorkerLost("the worker process of cuda:1 died twice")

    monkeypatch.setattr(engine, "dispatch_device", lost)
    with pytest.raises(engine.WorkerLost):
        campaign(_sweep_grid(11), chunk_size=8, n_batches=64, seed=7,
                 fault_retries=3, **CPU)
    assert len(calls) == 1
