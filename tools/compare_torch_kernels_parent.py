#!/usr/bin/env python3
"""The campaign fold, the absorbed MLA decode and B5's float32 forward
and backward against an earlier checkout's kernels, on the cases
``chip_smoke.py`` launches.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_kernels_parent.py --parent build/parent

Builds the parent's ``src/repro_torch/kernels/csrc/campaign_fold.cu``,
``mla_decode.cu``, ``ssd_scan.cu`` and ``ssd_scan_backward.cu`` with
the port's ``nvcc`` flags into ``build/parent_kernels/``.  The fold and
MLA decode are called through the current wrappers with the parent's
libraries in place of the current ones (the C entry points are the
same since PR 30: a parent from before it is not supported); B5's
through the parent's C entry points directly (below).  On the same
inputs:

- the fold, on every case of ``chip_smoke.py``'s ``campaign_fold``
  phase (``FOLD_CASES``), two chunks in a row: bit for bit equal to the
  parent's, accumulator and summary, where the parent takes the case
  (a parent that refuses more top-K slots than it keeps, as before
  ROADMAP C-P4's repair, is listed, and the current fold is held to
  ``campaign_fold_plain`` there instead);
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
  plain versions';
- B5's float32 route (the parent's C entry points ``ssd_scan_launch``
  and ``ssd_scan_backward_launch``, called with the workspaces each
  kernel generation wants: the CUDA-core backward's per-head partials,
  the tensor-core one's per-head-block partials and ``dstates``): the
  forward at ``ssd_kernel``'s B 4 × 300 and the training shape B 2 ×
  512 on mamba2-2.7b's widths and at Jamba's (64, 16) B 32 × 32 and B 2
  × 300; the backward at B 2 × 512 and B 1 × 4,096 on mamba2's widths,
  at Jamba's B 2 × 512, and a ragged B 2 × 300 with a final-state
  gradient (errors only); both generations' errors against the plain
  versions (each gradient within 1e-4 of its largest magnitude) and,
  for the forward, against the recurrence stepped in float64 on the
  card (y and the state within 1e-4; the plain version's own distance
  from it beside: its float32 dual form over 256-step chunks is the
  least accurate of the three), both timed in turns with the plain
  version's time beside.

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
    """The parent's fold and MLA decode libraries, and its B5 float32
    entry points."""
    fold = _nvcc_library(parent, "campaign_fold")
    mla = _nvcc_library(parent, "mla_decode")
    fwd = _nvcc_library(parent, "ssd_scan").ssd_scan_launch
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = _nvcc_library(parent, "ssd_scan_backward").ssd_scan_backward_launch
    bwd.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fold, mla, fwd, bwd


def through(name: str, lib, fn):
    """``fn()`` with the wrappers' ``library(name)`` returning ``lib``."""
    _build.library(name)                     # the current one, loaded
    keep = _build._LOADED[name]
    _build._LOADED[name] = lib
    try:
        return fn()
    finally:
        _build._LOADED[name] = keep


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
    old_fold, old_mla, old_fwd, old_bwd = parent_entries(args.parent)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def parent_fold(acc, c, g, n_valid, has_loss, sketch):
        """The parent's fold: (summary, 0), or (None, 1) where it
        refuses the case."""
        try:
            return through("campaign_fold", old_fold,
                           lambda: cf.campaign_fold(acc, c, g, n_valid,
                                                    has_loss=has_loss,
                                                    sketch=sketch)), 0
        except RuntimeError:
            return None, 1

    fold_ok, fold_differ, chunks_of, parent_refuses = 0, [], {}, []
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
            if err != 0 and name not in parent_refuses:
                parent_refuses.append(name)
            if name in parent_refuses:
                s_old = cf.campaign_fold_plain(old, c, g, n_valid,
                                               has_loss=has_loss,
                                               sketch=sketch)
            torch.cuda.synchronize()
            ok = ok and torch.equal(s_new, s_old) \
                and smoke._acc_equal(new, old)
        fold_ok += ok
        if not ok:
            fold_differ.append(name)

    mla_timed, mla_rest = smoke.mla_decode_cases()
    mla_ok, mla_differ = 0, []
    worst = dict(current=0.0, parent=0.0)

    def parent_mla(q_abs, q_pe, c_kv, k_pe, lens, window):
        return through("mla_decode", old_mla,
                       lambda: md.mla_decode_attention(
                           q_abs, q_pe, c_kv, k_pe, lens,
                           scale=smoke.MLA_SCALE, window=window))

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
        ref, err = parent_mla(*args_, lens, window), 0
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
            sdpa_ms=smoke.time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=smoke.MLA_SCALE,
                    enable_gqa=True)),
            plain_ms=smoke.time_ms(lambda: md.mla_decode_attention_plain(
                q_abs, q_pe, c_kv, k_pe, lens, scale=smoke.MLA_SCALE,
                window=window)))
    ssd = compare_ssd_f32(dev, stream, old_fwd, old_bwd)
    n_fold, n_mla = len(smoke.FOLD_CASES), len(inputs)
    print(json.dumps({"fold_cases": n_fold, "fold_bitwise_parent": fold_ok,
                      "fold_parent_refuses": parent_refuses,
                      "mla_cases": n_mla, "mla_ok": mla_ok,
                      "differ": fold_differ + mla_differ + ssd["differ"],
                      "mla_worst_over_gate": worst,
                      "chain_floor_ms": floor_ms, "timed": timed,
                      "ssd_f32": ssd["cases"],
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.nvidia_smi()}), flush=True)
    return 0 if (fold_ok == n_fold and mla_ok == n_mla
                 and not ssd["differ"]) else 1


def compare_ssd_f32(dev, stream, old_fwd, old_bwd) -> dict:
    """B5's float32 forward and backward, the parent's kernels against
    the current ones (see the module note)."""
    from repro_torch.kernels import ssd_scan as ss

    mamba, jamba = smoke.get_config(smoke.SSM_ARCH), smoke.hybrid_config()
    f32 = torch.float32

    def widths(model):
        c = model.ssm
        return c.n_heads(model.d_model), c.head_dim, c.d_state

    def float64_scan(x, dt, a, bm, cm):
        b, s, nh, hd = x.shape
        rep_ = nh // bm.shape[2]
        xd, dd, ad = x.double(), dt.double(), a.double()
        bd = bm.double().repeat_interleave(rep_, 2)
        cd = cm.double().repeat_interleave(rep_, 2)
        h = torch.zeros(b, nh, hd, bm.shape[3], dtype=torch.float64,
                        device=dev)
        y = torch.empty(b, s, nh, hd, dtype=torch.float64, device=dev)
        for t in range(s):
            h = (h * torch.exp(dd[:, t] * ad)[..., None, None]
                 + dd[:, t, :, None, None] * xd[:, t, :, :, None]
                 * bd[:, t, :, None, :])
            y[:, t] = torch.einsum("bhds,bhs->bhd", h, cd[:, t])
        return y, h

    def parent_forward(x, dt, a, bm, cm):
        b, s, nh, hd = x.shape
        g, ds = bm.shape[2], bm.shape[3]
        y = torch.empty(b, s, nh, hd, device=dev)
        h = torch.empty(b, nh, hd, ds, device=dev)
        err = old_fwd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      bm.data_ptr(), cm.data_ptr(), y.data_ptr(), 1,
                      h.data_ptr(), None, b, s, nh, g, hd, ds, 0,
                      bm.stride(0), bm.stride(1), max(s, 1), 1, stream)
        return y, h, err

    def parent_backward(x, dt, a, bm, cm, dy, dh):
        # the parent's CUDA-core route: per-head partials, one per batch
        # row for dA, no dstates
        b, s, nh, hd = x.shape
        g, ds = bm.shape[2], bm.shape[3]
        tiles = -(-s // 64)
        f = dict(dtype=f32, device=dev)
        states = torch.empty(b * nh * tiles * hd * ds, **f)
        db_part = torch.empty(b * s * nh * ds, **f)
        dc_part = torch.empty_like(db_part)
        da_part = torch.empty(b * nh, **f)
        dx, ddt = torch.empty_like(x), torch.empty(b, s, nh, **f)
        da = torch.zeros(nh, **f)
        db, dc = torch.empty(bm.shape, **f), torch.empty(cm.shape, **f)
        err = old_bwd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      bm.data_ptr(), cm.data_ptr(), dy.data_ptr(),
                      None if dh is None else dh.data_ptr(), dx.data_ptr(),
                      ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
                      dc.data_ptr(), states.data_ptr(), None,
                      db_part.data_ptr(), dc_part.data_ptr(),
                      da_part.data_ptr(), b, s, nh, g, hd, ds, 0, 1,
                      bm.stride(0), bm.stride(1), stream)
        return (dx, ddt, da, db, dc), err

    cases, differ = {}, []
    for name, model, b, s, seed in (
            ("forward_mamba2_4x300", mamba, 4, 300, 5),
            ("forward_mamba2_2x512", mamba, 2, 512, 11),
            ("forward_jamba_32x32", jamba, 32, 32, 106),
            ("forward_jamba_2x300", jamba, 2, 300, 107)):
        nh, hd, ds = widths(model)
        args = smoke._ssd_inputs(dev, f32, b, s, nh, 1, hd, ds, seed)
        y, h = ss.ssd_chunked(*args, model.ssm.chunk_size)
        py, ph, code = parent_forward(*args)
        wy, wh = ss.ssd_scan_plain(*args, model.ssm.chunk_size)
        ty, th = float64_scan(*args)
        torch.cuda.synchronize()

        def err(u, v, tu, tv):
            return max(float((u.double() - tu).abs().max()),
                       float((v.double() - tv).abs().max()))

        cur, par = err(y, h, wy, wh), err(py, ph, wy, wh)
        cur64, par64 = err(y, h, ty, th), err(py, ph, ty, th)
        turns = time_turns(lambda: parent_forward(*args),
                           lambda: ss.ssd_chunked(*args,
                                                  model.ssm.chunk_size))
        cases[name] = dict(
            batch=b, seq=s, heads=nh, head_dim=hd, d_state=ds,
            max_abs_err=cur, parent_max_abs_err=par, err_f64=cur64,
            parent_err_f64=par64, plain_err_f64=err(wy, wh, ty, th),
            max_abs_y=float(wy.abs().max()), parent_ms=turns[0::3],
            current_ms=turns[1:3], plain_ms=smoke.time_ms(
                lambda: ss.ssd_scan_plain(*args, model.ssm.chunk_size),
                3, 1))
        if code != 0 or cur64 > 1e-4 or par64 > 1e-4:
            differ.append([name, cur64, par64, code])
        del args, y, h, py, ph, wy, wh, ty, th
    for name, model, b, s, seed, with_dh, timed in (
            ("backward_mamba2_2x512", mamba, 2, 512, 91, False, True),
            ("backward_mamba2_1x4096", mamba, 1, 4096, 92, False, True),
            ("backward_jamba_2x512", jamba, 2, 512, 93, False, True),
            ("backward_mamba2_2x300_dh", mamba, 2, 300, 95, True, False)):
        nh, hd, ds = widths(model)
        x, dt, a, bm, cm = smoke._ssd_inputs(dev, f32, b, s, nh, 1, hd, ds,
                                             seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1000)
        dy = torch.randn(b, s, nh, hd, device=dev, generator=gen)
        dh = (torch.randn(b, nh, hd, ds, device=dev, generator=gen)
              if with_dh else None)
        args = (x, dt, a, bm, cm, dy, dh)
        got = ss.ssd_scan_backward(*args, model.ssm.chunk_size)
        old, err = parent_backward(*args)
        want = ss.ssd_scan_backward_plain(*args, model.ssm.chunk_size)
        torch.cuda.synchronize()
        over = {}
        for gname, k, p, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, old,
                                  want):
            scale = max(float(w.abs().max()), 1e-30)
            over[gname] = [float((k - w).abs().max()) / scale,
                           float((p - w).abs().max()) / scale]
        case = dict(batch=b, seq=s, heads=nh, head_dim=hd, d_state=ds,
                    dh_end=with_dh, rel_err_current_parent=over)
        if timed:
            turns = time_turns(
                lambda: parent_backward(*args),
                lambda: ss.ssd_scan_backward(*args, model.ssm.chunk_size))
            case.update(parent_ms=turns[0::3], current_ms=turns[1:3],
                        hpb=ss.backward_heads(b, s, nh, 1, torch.cuda
                                              .get_device_properties(dev)
                                              .multi_processor_count),
                        plain_ms=smoke.time_ms(
                            lambda: ss.ssd_scan_backward_plain(
                                *args, model.ssm.chunk_size), 3, 1))
        cases[name] = case
        if err != 0 or max(max(v) for v in over.values()) > 1e-4:
            differ.append([name, over, err])
        del x, dt, a, bm, cm, dy, dh, got, old, want
        torch.cuda.empty_cache()
    return dict(cases=cases, differ=differ)


if __name__ == "__main__":
    sys.exit(main())
