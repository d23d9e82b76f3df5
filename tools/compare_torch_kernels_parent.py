#!/usr/bin/env python3
"""The campaign fold and the absorbed MLA decode against an earlier
checkout's kernels, on the cases ``chip_smoke.py`` launches.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_kernels_parent.py --parent build/parent

Builds the parent's ``src/repro_torch/kernels/csrc/campaign_fold.cu``
and ``mla_decode.cu`` with the port's ``nvcc`` flags into
``build/parent_kernels/`` and calls their C entry points with the
argument lists the parent exports (the fold: a ``FoldArgs`` pointer and
the stream; MLA decode: q_abs, q_pe, c_kv, k_pe, lengths, out, ws, B,
S, H, R, P, dtype, scale, window, chunk, splits, stream, with the
parent's split rule: 32-position tiles, about two blocks an SM), and
the current ``campaign_fold`` / ``mla_decode_attention`` on the same
inputs:

- the fold, on every case of ``chip_smoke.py``'s ``campaign_fold``
  phase (``FOLD_CASES``), two chunks in a row: bit for bit equal to the
  parent's, accumulator and summary;
- MLA decode, on every case of its ``mla_kernel`` phase
  (``mla_decode_cases``): both kernels within 2e-5 of the plain
  version, both errors reported (not bitwise: the two kernels sum in
  another order);
- timed, in turns (parent, current, current, parent; CUDA events behind
  a device sleep): the fold's path case (8,192 × 512 with loss rows),
  its loss-free and sketch (8,192 × 64) cases, and one thread's chain of
  8,192 dependent float64 additions (``chain_floor_ms``, the floor of
  the fold's ordered sums); MLA decode at serve_mla's last decode step
  (B 32, 37 slots), the long cache (B 32 × 1,057) in bf16 and float32,
  and batch 1 over it, with SDPA's time on the same inputs and the
  plain versions'.

Prints one JSON line with the counts, the cases that differ and the
timings, with the card's name and power limit, and exits 1 if any case
fails.  Needs one CUDA device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import campaign_fold as cf  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.kernels._launch import DTYPE_CODE  # noqa: E402

GATE = 2e-5
M = 8192


def _nvcc_library(parent: Path, name: str):
    src = parent / f"src/repro_torch/kernels/csrc/{name}.cu"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True)
    return ctypes.CDLL(str(so))


def parent_entries(parent: Path):
    fold = _nvcc_library(parent, "campaign_fold").campaign_fold_launch
    fold.argtypes = [ctypes.POINTER(cf._FoldArgs), ctypes.c_void_p]
    fold.restype = ctypes.c_int
    mla = _nvcc_library(parent, "mla_decode").mla_decode_launch
    mla.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    mla.restype = ctypes.c_int
    return fold, mla


def parent_splits(b: int, s: int, sms: int):
    """The parent's ``mla_splits``: 32-position tiles, about two blocks
    an SM, at most 64 splits."""
    tiles = max(1, -(-s // 32))
    splits = max(1, min(-(-2 * sms // max(1, b)), tiles, 64))
    chunk = -(-tiles // splits) * 32
    return max(1, -(-s // chunk)), chunk


def time_turns(run_old, run_new, reps=10):
    """(parent, current, current, parent) mean ms a call."""
    return [smoke.time_ms(f, reps) for f in (run_old, run_new, run_new,
                                             run_old)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_kernels_parent: needs a CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old_fold, old_mla = parent_entries(args.parent)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def fold_args(acc, c, g, n_valid, has_loss, sketch, summary):
        keys = list(cf._F32 + cf._I32) + (["hist_sums"] if sketch else [])
        keys += list(cf.LOSS_KEYS) if has_loss else []

        def ptr(key):
            return c[key].data_ptr() if key in keys else None

        return cf._FoldArgs(
            hist=ptr("hist"), hist_sums=ptr("hist_sums"),
            n_jobs=ptr("n_jobs"), batches=ptr("batches"),
            dropped=ptr("dropped"), lat=ptr("mean_latency"),
            util=ptr("utilization"), batch=ptr("mean_batch"),
            lam=ptr("lam"), bm_m2=ptr("lat_bm_m2"), bm_n=ptr("lat_bm_n"),
            overflow=ptr("overflow_dropped"), abandoned=ptr("abandoned"),
            in_slo=ptr("n_in_slo"), fresh=ptr("n_fresh"),
            retry=ptr("n_retry"), gidx=g.data_ptr(),
            ints=acc.ints.data_ptr(), floats=acc.floats.data_ptr(),
            summary=summary.data_ptr(), m=M, n_valid=int(n_valid),
            n_bins=acc.n_bins, k_top=acc.k_top, has_loss=int(has_loss),
            sketch=int(sketch))

    def parent_fold(acc, c, g, n_valid, has_loss, sketch):
        summary = torch.zeros(6 if has_loss else 4, dtype=torch.int64,
                              device=dev)
        a = fold_args(acc, c, g, n_valid, has_loss, sketch, summary)
        return summary, old_fold(ctypes.byref(a), stream)

    fold_ok, fold_differ, chunks_of = 0, [], {}
    for i, (name, (n_bins, has_loss, sketch, poison, short, k_top,
                   tied)) in enumerate(smoke.FOLD_CASES.items()):
        rng = np.random.default_rng(i + 17)
        chunks = [smoke._fold_chunk(dev, rng, M, n_bins, has_loss, sketch,
                                    poison, tied) for _ in range(2)]
        chunks_of[name] = chunks
        init = smoke.campaign_init_acc(n_bins, k_top)
        new = cf.FoldAcc.from_host(init, dev)
        old = cf.FoldAcc.from_host(init, dev)
        n_valid = 0 if short is None else M - short
        ok = True
        for j, c in enumerate(chunks):
            g = torch.arange(j * M, (j + 1) * M, dtype=torch.int64,
                             device=dev)
            s_new = cf.campaign_fold(new, c, g, n_valid, has_loss=has_loss,
                                     sketch=sketch)
            s_old, err = parent_fold(old, c, g, n_valid, has_loss, sketch)
            torch.cuda.synchronize()
            ok = ok and err == 0 and torch.equal(s_new, s_old) \
                and smoke._acc_equal(new, old)
        fold_ok += ok
        if not ok:
            fold_differ.append(name)

    mla_timed, mla_rest = smoke.mla_decode_cases()
    mla_ok, mla_differ = 0, []
    worst = dict(current=0.0, parent=0.0)

    def parent_mla(q_abs, q_pe, c_kv, k_pe, lens, window):
        b, s = c_kv.shape[:2]
        splits, chunk = parent_splits(b, s, sms)
        out = torch.empty_like(q_abs)
        ws = torch.empty(splits * b * 16 * 514 if splits > 1 else 0,
                         device=dev)
        err = old_mla(q_abs.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(),
                      k_pe.data_ptr(), lens.data_ptr(), out.data_ptr(),
                      ws.data_ptr() if splits > 1 else None,
                      b, s, 16, 512, 64, DTYPE_CODE[c_kv.dtype],
                      smoke.MLA_SCALE, window, chunk, splits, stream)
        return out, err

    inputs = {}
    for key, (dt, b, s, lengths, window, seed) in (
            list(mla_timed.items()) + list(enumerate(mla_rest))):
        args_ = smoke._mla_inputs(dev, dt, b, s, seed)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        inputs[key] = (args_, lens, window)
        got = md.mla_decode_attention(*args_, lens, scale=smoke.MLA_SCALE,
                                      window=window)
        again = md.mla_decode_attention(*args_, lens, scale=smoke.MLA_SCALE,
                                        window=window)
        ref, err = parent_mla(*args_, lens, window)
        want = md.mla_decode_attention_plain(*args_, lens,
                                             scale=smoke.MLA_SCALE,
                                             window=window)
        torch.cuda.synchronize()
        cur = float((got - want).abs().max())
        par = float((ref - want).abs().max())
        worst["current"] = max(worst["current"], cur / GATE)
        worst["parent"] = max(worst["parent"], par / GATE)
        ok = (err == 0 and cur <= GATE and par <= GATE
              and torch.equal(got, again))
        mla_ok += ok
        if not ok:
            mla_differ.append([str(key), str(dt), b, s, window, cur, par,
                               err])

    timed = {}
    for name in ("loss", "full", "sketch"):
        n_bins, has_loss, sketch, _, short, k_top, _ = smoke.FOLD_CASES[name]
        c = chunks_of[name][0]
        g = torch.arange(M, dtype=torch.int64, device=dev)
        init = smoke.campaign_init_acc(n_bins, k_top)
        acc_new = cf.FoldAcc.from_host(init, dev)
        acc_old = cf.FoldAcc.from_host(init, dev)
        turns = time_turns(
            lambda: parent_fold(acc_old, c, g, M - short, has_loss, sketch),
            lambda: cf.campaign_fold(acc_new, c, g, M - short,
                                     has_loss=has_loss, sketch=sketch))
        timed[f"fold_{name}"] = dict(
            parent_ms=turns[0::3], current_ms=turns[1:3],
            plain_ms=smoke.time_ms(lambda: cf.campaign_fold_plain(
                acc_new, c, g, M - short, has_loss=has_loss, sketch=sketch),
                2, 1),
            bound_ms=cf.fold_min_bytes(M, n_bins, has_loss=has_loss,
                                       sketch=sketch, k_top=k_top)
            / smoke.HBM_BYTES_PER_S * 1e3)
    floor_ms = smoke.time_ms(lambda: cf.chain_floor(dev, M))
    for name in mla_timed:
        (q_abs, q_pe, c_kv, k_pe), lens, window = inputs[name]
        turns = time_turns(
            lambda: parent_mla(q_abs, q_pe, c_kv, k_pe, lens, window),
            lambda: md.mla_decode_attention(q_abs, q_pe, c_kv, k_pe, lens,
                                            scale=smoke.MLA_SCALE,
                                            window=window))
        b, s = c_kv.shape[:2]
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        qt = torch.cat([q_abs, q_pe], -1).to(c_kv.dtype)[:, :, None, :]
        kt = torch.cat([c_kv, k_pe], -1)[:, None]
        vt = c_kv[:, None]
        timed[f"mla_{name}"] = dict(
            parent_ms=turns[0::3], current_ms=turns[1:3],
            splits=md.mla_splits(b, s, sms)[0],
            parent_splits=parent_splits(b, s, sms)[0],
            sdpa_ms=smoke.time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=smoke.MLA_SCALE,
                    enable_gqa=True)),
            plain_ms=smoke.time_ms(lambda: md.mla_decode_attention_plain(
                q_abs, q_pe, c_kv, k_pe, lens, scale=smoke.MLA_SCALE,
                window=window)))
    n_fold, n_mla = len(smoke.FOLD_CASES), len(inputs)
    print(json.dumps({"fold_cases": n_fold, "fold_bitwise_parent": fold_ok,
                      "mla_cases": n_mla, "mla_ok": mla_ok,
                      "differ": fold_differ + mla_differ,
                      "mla_worst_over_gate": worst,
                      "chain_floor_ms": floor_ms, "timed": timed,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.nvidia_smi()}), flush=True)
    return 0 if fold_ok == n_fold and mla_ok == n_mla else 1


if __name__ == "__main__":
    sys.exit(main())
