"""The port's continuous-batching engine against the reference's, and the
decode write at lengths outside the cache.

Both engines serve the same Poisson trace on the same weights (the
reference's, carried across by ``convert.model_params_from_jax``) with
``_timed`` replaced by a fixed step of 10 ms, so the virtual clock is
the same in both, and with the reference's ``_write_slot`` indexing
its pool rows on the batch axis (its own indexes the stacked layers'
axis, ROADMAP C-R3, shown by a test of its own): every
``ContinuousServeResult`` field is equal (latencies bit for bit) and the
pool's greedy tokens are equal after every decode step.  The models run in float32 on the CPU (reduced
qwen1.5-0.5b, mamba2-2.7b and OLMoE; prompt 8, 4 tokens, 4 slots, 40
jobs); at λ = 12/s most steps have one or two active slots, so the
higher slots stay idle for more than ``cache_len`` = 13 steps and their
lengths run past the cache, which the port's decode must then leave
alone, as the reference's mask-select does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import attention as ref_attn
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import attention as pt_attn
from repro_torch.serving import ContinuousEngine, ContinuousServeResult

ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b", "olmoe-1b-7b"]
PROMPT, GEN, SLOTS, JOBS, LAM, DT = 8, 4, 4, 40, 12.0, 0.01


def _write_slot_by_row(eng):
    """The reference engine's ``_write_slot`` with its pool rows indexed
    on the batch axis.  Its own (``src/repro/serving/continuous.py:92``)
    writes ``pool.at[slot]``, which on the stacked layers' leaves ``(r,
    B, ...)`` is the layer axis (ROADMAP C-R3)."""
    def write(slot, cache_one, tok_one):
        pool = eng._pool_cache
        eng._pool_cache = {
            "lead": [jax.tree.map(lambda a, o: a.at[slot].set(o[0]), p, c)
                     for p, c in zip(pool["lead"], cache_one["lead"])],
            "stack": [jax.tree.map(lambda a, o: a.at[:, slot].set(o[:, 0]),
                                   p, c)
                      for p, c in zip(pool["stack"], cache_one["stack"])]}
        eng._pool_tok = eng._pool_tok.at[slot].set(tok_one[0])
        eng._pool_len = eng._pool_len.at[slot].set(eng.prompt_len)
    eng._write_slot = write


def _fixed_clock(eng, decode_fn, record):
    """``_timed`` at a fixed DT, recording the pool's tokens after each
    decode step."""
    def timed(fn, *args):
        out = fn(*args)
        if fn == decode_fn():
            record.append(np.asarray(out[0]).reshape(-1).copy())
        return out, DT
    eng._timed = timed


@pytest.fixture(scope="module")
def served():
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        ref = RefEngine(cfg, prompt_len=PROMPT, gen_tokens=GEN,
                        max_active=SLOTS, seed=0)
        port = ContinuousEngine(pt_reduced(pt_get_config(arch)),
                                prompt_len=PROMPT, gen_tokens=GEN,
                                max_active=SLOTS, seed=0, device="cpu")
        port.params = model_params_from_jax(
            port.cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
        _write_slot_by_row(ref)
        ref_toks, port_toks = [], []
        _fixed_clock(ref, lambda: ref._decode, ref_toks)
        _fixed_clock(port, lambda: port._decode, port_toks)
        want = ref.serve_poisson(LAM, n_jobs=JOBS, seed=0)
        got = port.serve_poisson(LAM, n_jobs=JOBS, seed=0)
        out[arch] = (ref, port, want, got, ref_toks, port_toks)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_result_equals_reference(arch, served):
    _, _, want, got, _, _ = served[arch]
    assert isinstance(got, ContinuousServeResult)
    for name in ("lam", "n_jobs", "mean_latency", "latency_p50",
                 "latency_p99", "mean_active", "utilization", "steps"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert got.n_jobs == JOBS and 1 <= got.mean_active <= SLOTS


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_tokens_equal_reference_after_every_step(arch, served):
    _, _, want, _, ref_toks, port_toks = served[arch]
    # the warm-up's step, then one per served step
    assert len(port_toks) == len(ref_toks) == want.steps + 1
    for i, (a, b) in enumerate(zip(port_toks, ref_toks)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_slots_run_past_the_cache(arch, served):
    ref, port, _, _, _, _ = served[arch]
    lens = port._pool_len.numpy()
    np.testing.assert_array_equal(lens, np.asarray(ref._pool_len))
    assert lens.max() > port.cache_len


def test_pool_cache_equals_reference_after_serving(served):
    ref, port, _, _, _, _ = served["qwen1.5-0.5b"]
    for i, layer in enumerate(port._pool_cache):
        for name, t in layer.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(ref._pool_cache["stack"][0][name][i]),
                rtol=0, atol=1e-5)


def test_reference_write_slot_indexes_the_layer_axis():
    """C-R3: the reference's own ``_write_slot`` sets layer ``slot`` of
    every stacked cache tensor (every row of it) to the prompt's layer 0,
    and writes nothing for a slot past the stack's depth; the port's
    writes the slot's row of every layer."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    ref = RefEngine(cfg, prompt_len=PROMPT, gen_tokens=GEN, max_active=SLOTS)
    port = ContinuousEngine(pt_reduced(pt_get_config("qwen1.5-0.5b")),
                            prompt_len=PROMPT, gen_tokens=GEN,
                            max_active=SLOTS, device="cpu")
    port.params = model_params_from_jax(
        port.cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             size=(1, PROMPT))
    tok, cache = ref._prefill(ref.params, jnp.asarray(toks, jnp.int32))
    ref._write_slot(1, cache, tok)
    pool = np.asarray(ref._pool_cache["stack"][0]["k"])    # (r, B, S, ..)
    one = np.asarray(cache["stack"][0]["k"])                # (r, 1, S, ..)
    for row in range(SLOTS):
        np.testing.assert_array_equal(pool[1, row], one[0, 0])
    assert not pool[:, 1][0].any()                          # layer 0, row 1
    ptok, pcache = port._prefill(port.params, torch.as_tensor(toks))
    port._write_slot(1, pcache, ptok)
    for layer in range(cfg.num_layers):
        got = port._pool_cache[layer]["k"].numpy()
        np.testing.assert_allclose(got[1], one[layer, 0], rtol=0, atol=1e-5)
        assert not np.delete(got, 1, axis=0).any()


def test_engine_defaults_to_cuda():
    cfg = pt_reduced(pt_get_config("qwen1.5-0.5b"))
    if torch.cuda.is_available():
        eng = ContinuousEngine(cfg, prompt_len=4, gen_tokens=2, max_active=2)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousEngine(cfg, prompt_len=4, gen_tokens=2, max_active=2)


# ---------------------------------------------------------------------------
# the decode write at lengths outside [0, S)
# ---------------------------------------------------------------------------

S_CACHE = 12
# rows in range, and rows at -1, S and S + 5
LENGTHS = [3, -1, S_CACHE, 0, S_CACHE + 5, S_CACHE - 1]


@pytest.fixture(scope="module")
def decode_rig():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    from repro.models.attention import init_gqa
    p = init_gqa(jax.random.PRNGKey(3), cfg, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(3)
    b = len(LENGTHS)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    shape = (b, S_CACHE, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return cfg, p, pt, x, k, v


def test_index_write_outside_the_cache_is_the_gap():
    """What a plain index write does at those lengths: it raises at S
    and beyond, and wraps -1 to the last slot."""
    cache = torch.zeros(2, S_CACHE)
    with pytest.raises(IndexError):
        cache[torch.arange(2), torch.tensor([0, S_CACHE])] = 1.0
    cache[torch.arange(2), torch.tensor([0, -1])] = 1.0
    assert cache[1, S_CACHE - 1] == 1.0


def test_decode_writes_nothing_outside_the_cache(decode_rig):
    cfg, p, pt, x, k, v = decode_rig
    lens = np.asarray(LENGTHS, np.int32)
    want, wc = ref_attn.gqa_decode(p, cfg, jnp.asarray(x),
                                   {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                   jnp.asarray(lens))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got, gc = pt_attn.gqa_decode(pt, cfg, torch.from_numpy(x), cache,
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    out = (lens < 0) | (lens >= S_CACHE)
    for name, before in (("k", k), ("v", v)):
        np.testing.assert_array_equal(gc[name].numpy()[out], before[out])
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]),
                                   rtol=0, atol=1e-5)
        # the in-range rows changed at their own slot only
        diff = (gc[name].numpy() != before).any(axis=(2, 3))
        for row, n in enumerate(lens):
            assert list(np.flatnonzero(diff[row])) == (
                [] if out[row] else [n])


def test_int8_decode_writes_nothing_outside_the_cache(decode_rig):
    cfg, p, pt, x, k, v = decode_rig
    lens = np.asarray(LENGTHS, np.int32)
    kq, ks = ref_attn.quantize_kv(jnp.asarray(k))
    vq, vs = ref_attn.quantize_kv(jnp.asarray(v))
    ref_cache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    want, wc = ref_attn.gqa_decode(p, cfg, jnp.asarray(x), ref_cache,
                                   jnp.asarray(lens))
    before = {n: np.array(t) for n, t in ref_cache.items()}
    cache = {n: torch.from_numpy(t.copy()) for n, t in before.items()}
    got, gc = pt_attn.gqa_decode(pt, cfg, torch.from_numpy(x), cache,
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    out = (lens < 0) | (lens >= S_CACHE)
    for name, t in gc.items():
        np.testing.assert_array_equal(t.numpy()[out], before[name][out])
        # the new rows' scales come from projections that differ in the
        # last bit, so they agree to 1e-6 relative; the codes exactly
        np.testing.assert_allclose(t.numpy(), np.asarray(wc[name]),
                                   rtol=1e-6, atol=0)


def test_a_row_past_the_cache_attends_to_all_of_it(decode_rig):
    """lengths of S and S + 5 admit every slot (the kernel clamps its
    interval to S), and -1 admits none: its output is exactly 0."""
    cfg, p, pt, x, k, v = decode_rig
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    q = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (len(LENGTHS), cfg.num_heads, cfg.head_dim)).astype(np.float32))
    from repro_torch.kernels.decode_attention import decode_attention
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    out = decode_attention(q, kt, vt, lens)
    full = decode_attention(q, kt, vt, torch.full_like(lens, S_CACHE - 1))
    assert bool((out[1] == 0).all())
    for row in (2, 4):
        torch.testing.assert_close(out[row], full[row], rtol=0, atol=0)
