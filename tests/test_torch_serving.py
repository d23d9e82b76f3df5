"""The port's dynamic-batching inference server against the reference's.

- Trace: ``serve_poisson``'s virtual-clock loop over a stub
  ``run_batch`` with the V100 τ[b] (as tests/test_engine_trace.py
  does) gives bitwise the reference's latencies and batch sizes under
  all three policies.
- Fit: ``fit_service_model`` is bitwise the reference's.
- Real model: on reduced qwen1.5-0.5b and reduced mamba2-2.7b
  (float32, CPU), with the reference engine's weights converted, the
  generate workload's greedy tokens and the forward workload's argmax
  tokens equal the reference engine's jitted ``run`` on the same seed
  and batch.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.analytic import LinearServiceModel
from repro.core.calibrate import fit_linear as ref_fit_linear
from repro.core.calibrate import fit_service_model as ref_fit
from repro.core.policy import BatchAllWaiting as RefBatchAll
from repro.core.policy import CappedBatch as RefCapped
from repro.core.policy import TimeoutBatch as RefTimeout
from repro.serving.engine import InferenceEngine as RefEngine
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.core import (BatchAllWaiting, CappedBatch, TimeoutBatch,
                              fit_linear, fit_service_model)
from repro_torch.launch import serve
from repro_torch.serving import InferenceEngine
from repro_torch.serving.engine import _buckets

V100 = LinearServiceModel(alpha=0.1438, tau0=1.8874)
POLICIES = {
    "batch-all": (RefBatchAll(), BatchAllWaiting()),
    "capped": (RefCapped(cap=8), CappedBatch(cap=8)),
    "timeout": (RefTimeout(max_wait=0.8, target=6, cap=16),
                TimeoutBatch(max_wait=0.8, target=6, cap=16)),
}


def _trace_engine(base):
    class _Trace(base):
        """serve_poisson's event loop over deterministic service times:
        no model is built, nothing executes."""

        def __init__(self, max_batch: int = 256):
            self.max_batch = max_batch
            self.buckets = [max_batch]

        def run_batch(self, b: int) -> float:
            return float(V100.tau(b))

    return _Trace()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_serve_poisson_trace_is_bitwise_the_reference(policy):
    ref_pol, pol = POLICIES[policy]
    for lam, seed in ((0.5 / V100.alpha, 3), (2.0, 11)):
        want = _trace_engine(RefEngine).serve_poisson(
            lam, n_jobs=400, policy=ref_pol, seed=seed, warmup=False)
        got = _trace_engine(InferenceEngine).serve_poisson(
            lam, n_jobs=400, policy=pol, seed=seed, warmup=False)
        assert np.array_equal(got.batch_sizes, want.batch_sizes)
        assert np.array_equal(got.latencies, want.latencies)
        for f in ("mean_latency", "latency_p50", "latency_p95",
                  "latency_p99", "mean_batch", "utilization"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.bucket_of == want.bucket_of


def test_fit_service_model_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    b = np.array([1, 2, 4, 8, 16, 32], float)
    for _ in range(5):
        tau = 0.02 + 0.001 * b + rng.normal(0, 2e-4, size=b.size)
        (m, r2), (rm, rr2) = fit_service_model(b, tau), ref_fit(b, tau)
        assert (m.alpha, m.tau0, r2) == (rm.alpha, rm.tau0, rr2)
        f, rf = fit_linear(b, tau), ref_fit_linear(b, tau)
        assert (f.slope, f.intercept, f.r2) == (rf.slope, rf.intercept,
                                                 rf.r2)
    # the clamps: a falling curve fits α at its floor
    m, _ = fit_service_model(b, 1.0 - 0.01 * b)
    rm, _ = ref_fit(b, 1.0 - 0.01 * b)
    assert (m.alpha, m.tau0) == (rm.alpha, rm.tau0)


def test_buckets_are_the_references():
    from repro.serving.engine import _buckets as ref_buckets
    for mb in (1, 5, 16, 32, 48, 64):
        assert _buckets(mb) == ref_buckets(mb)


@pytest.fixture(scope="module",
                params=[("qwen1.5-0.5b", "generate"),
                        ("qwen1.5-0.5b", "forward"),
                        ("mamba2-2.7b", "generate"),
                        ("mamba2-2.7b", "forward")],
                ids=["generate", "forward", "mamba2-generate",
                     "mamba2-forward"])
def engines(request):
    """The reference engine and the port's on the same weights."""
    arch, workload = request.param
    ref = RefEngine(reduced(get_config(arch)), workload=workload,
                    seq_len=32, max_batch=8, seed=3)
    port = InferenceEngine(pt_reduced(pt_get_config(arch)),
                           workload=workload, seq_len=32, max_batch=8,
                           seed=3, device="cpu")
    port.params = model_params_from_jax(
        port.cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
    return ref, port


def test_tokens_equal_the_reference_engines(engines):
    ref, port = engines
    for b in (1, 8):
        want_batch, got_batch = ref._make_batch(b), port._make_batch(b)
        assert np.array_equal(np.asarray(want_batch["tokens"]),
                              got_batch["tokens"].numpy())
        want = np.asarray(ref._fns[b](ref.params, want_batch))
        got = port._fns[b](port.params, got_batch).numpy()
        if ref.workload == "generate":
            assert got.shape == (b, ref.gen_tokens)
        else:
            assert got.shape == (b,)
        assert np.array_equal(got, want)


def test_calibrate_gives_one_positive_tau_per_bucket(engines):
    _, port = engines
    n0 = port.batches_run
    b, tau = port.calibrate(samples=2)
    assert b.tolist() == [1.0, 2.0, 4.0, 8.0]
    assert tau.shape == (4,) and bool(np.all(tau > 0))
    assert port.batches_run - n0 == 4 + 4 * 2     # warmup + samples


def test_serve_cli_runs_the_reduced_model_on_the_cpu():
    args = serve.parse_args(["--workload", "generate", "--jobs", "40",
                             "--max-batch", "4", "--policy", "capped"])
    out = serve.run(args, device="cpu")
    res = out["result"]
    assert res.n_jobs == 40 and len(res.latencies) == 40
    assert res.batch_sizes.max() <= 4
    assert len(out["tau_s"]) == len(out["buckets"]) == 3
    assert out["alpha_s"] > 0 and np.isfinite(out["phi_s"])


def test_serve_cli_runs_reduced_mamba2_on_the_cpu():
    args = serve.parse_args(["--arch", "mamba2-2.7b", "--workload",
                             "generate", "--jobs", "20", "--max-batch", "2"])
    out = serve.run(args, device="cpu")
    res = out["result"]
    assert out["engine"].cfg.name == "mamba2-2.7b-reduced"
    assert res.n_jobs == 20 and len(res.latencies) == 20
    assert bool(np.all(np.isfinite(res.latencies)))
    assert len(out["tau_s"]) == 2 and all(t > 0 for t in out["tau_s"])


def test_engine_defaults_to_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = pt_reduced(pt_get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.parse_args(["--jobs", "4"]))
