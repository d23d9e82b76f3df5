"""A run with the timed path broken underneath comes out not correct.

The harness runs as a benchmark run does, but on the CPU at tiny widths
(it skips only the look for a card), with the cells' own limits, and a
fault planted in the program's model calls after set-up: an answer
altered where it is produced, half of each batch left out (its rows
given the other half's answers and, after a prefill, caches), and a
decode step that hands back its cache unchanged.  One card serves every cell, so no exchange between
chips can be left out.
"""
import time

import pytest
import torch

from gpubench.lib import catalog
from gpubench.tests import tiny


def _altered(server):
    """Row 0's logits negated where the model produces them."""
    cap = server.capture
    fwd, dec = cap._forward, cap._decode

    def forward(params, batch, **kw):
        lg, aux = fwd(params, batch, **kw)
        lg = lg.clone()
        lg[0] = -lg[0]
        return lg, aux

    def decode(params, tokens, cache, lengths, **kw):
        lg, cache = dec(params, tokens, cache, lengths, **kw)
        lg = lg.clone()
        lg[0] = -lg[0]
        return lg, cache

    cap._forward, cap._decode = forward, decode


def _half(server):
    """Only the first half of each batch's rows computed; the rest given
    their answers (and, after a prefill, their caches)."""
    cap = server.capture
    fwd, pre = cap._forward, cap._prefill

    def split(toks):
        half = max(1, toks.shape[0] // 2)
        return toks[:half], torch.arange(toks.shape[0]) % half

    def forward(params, batch, **kw):
        toks, rows = split(batch["tokens"])
        lg, aux = fwd(params, {"tokens": toks}, **kw)
        return lg[rows], aux

    def prefill(params, batch, cache_len, **kw):
        toks, rows = split(batch["tokens"])
        lg, cache = pre(params, {"tokens": toks}, cache_len, **kw)
        return lg[rows], [{k: v[rows] for k, v in c.items()} for c in cache]

    cap._forward, cap._prefill = forward, prefill


def _stale(server):
    """Each decode step writes into a copy of the cache and returns the
    cache it was given, unchanged."""
    cap = server.capture
    dec = cap._decode

    def decode(params, tokens, cache, lengths, **kw):
        copy = [{k: v.clone() for k, v in c.items()} for c in cache]
        lg, _ = dec(params, tokens, copy, lengths, **kw)
        return lg, cache

    cap._decode = decode


# offered far above what the CPU serves, so that batches fill to b_max
CASES = {
    "dense-forward": (tiny.DENSE, tiny.traffic(b_max=8, rate=1000.0),
                      "phi4-prompt1k"),
    "moe-forward": (tiny.MOE, tiny.traffic(b_max=8, rate=1000.0),
                    "deepseek-prompt1k"),
    "moe-generate": (tiny.MOE, tiny.traffic("generate", gen_tokens=6,
                                            b_max=8, rate=300.0),
                     "deepseek-doc2k"),
}
FAULTS = [("dense-forward", None), ("dense-forward", _altered),
          ("dense-forward", _half), ("moe-forward", None),
          ("moe-forward", _altered), ("moe-forward", _half),
          ("moe-generate", None), ("moe-generate", _altered),
          ("moe-generate", _half), ("moe-generate", _stale)]


@pytest.mark.parametrize("case,fault", FAULTS, ids=[
    f"{c}-{f.__name__.strip('_') if f else 'sound'}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(case, fault):
    base, traffic, cell_name = CASES[case]
    cell = dict(catalog.cell(cell_name))
    cell["check"] = dict(cell["check"], requests=16)
    out = catalog.driver("serve").run(
        cell, tiny.config(base), traffic, seed=2 ** 33 + 17, seconds=0.2,
        trace=False, t_start=time.perf_counter(), device="cpu", strict=False,
        hooks=fault)
    assert out["correct"] is (fault is None), out["checks"]
