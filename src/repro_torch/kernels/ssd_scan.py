"""The Mamba2 SSD scan of the port: the CUDA kernel ``csrc/ssd_scan.cu``
and its plain torch version.

For x ``(B, S, nh, hd)``, dt ``(B, S, nh)`` float32 (post-softplus),
A ``(nh,)`` float32 (negative) and B, C ``(B, S, g, ds)`` with head h
reading group ``h // (nh // g)``, the scan runs the diagonal SSM
recurrence ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t ⊗ B_t``,
``y_t = h_t·C_t`` from ``h_0 = 0``.  There is no D skip term: the model
adds it.  It replaces the reference's Pallas kernel
``repro.kernels.ssd_scan`` (``_kernel``) and computes what the
reference model's ``_ssd_chunked`` computes.

- ``ssd_chunked(x, dt, A, B, C, chunk)`` is the model's call: y in
  float32 and the final state ``(B, nh, hd, ds)`` in float32, the
  prefill cache's ``ssm`` entry.
- ``ssd_scan(x, dt, a, bmat, cmat, chunk=256)`` keeps the reference
  kernel's name and keywords and returns y in x's dtype.
- ``ssd_scan_plain`` is the plain version: the chunked dual form of
  ``_ssd_chunked``, with the sequence padded to the chunk by dt = 0
  identity steps and the causal mask applied before ``exp``.

Both wrappers launch the kernel for CUDA tensors and take the plain
version for CPU tensors; they raise on any other device, on a dtype
other than float32 / bfloat16 for x, B, C (one dtype) or float32 for
dt, A, on ``nh % g != 0``, and, on the card, on a non-contiguous x, dt
or A, on B or C whose two inner axes are not packed, on bf16 rows that
do not start 16-byte aligned, and on head and state widths the kernel
is not built for (``WIDTHS``: mamba2-2.7b's, jamba-v0.1-52b's and
their reduced configs').
B and C may be slices of one activation: the kernel takes their batch
and time strides (float32 rows that do not start 16-byte aligned are
copied first).  Both dtypes run on the tensor cores: bfloat16 inputs
``ssd_scan_kernel_bf16`` (m16n8k16, each float32 operand as two bf16
terms) and float32 inputs ``ssd_scan_kernel_f32`` (m16n8k8 TF32 as
3xTF32: each operand split into a TF32 big term and a small term, three
products a product); both walk the time axis in tiles (bf16: 64 steps,
32 for a row of at most 32; float32: 32) whatever ``chunk`` is (SSD is
the same function for every chunk size, up to rounding), and a length
that is no multiple of the tile is masked in the kernel.  At small
batch the bf16 route cuts each row into ``ssd_splits`` pieces: a state
pass over the pieces
and a second pass that combines their states in piece order, through a
workspace kept per device (``ssd_piece_states_plain``,
``ssd_combine_plain`` and ``ssd_piece_plain`` are that algebra in plain
torch, for the tests).  A failed build or launch raises: there is no
fallback.

Gradients.  On CPU tensors autograd differentiates the plain version as
it is.  On CUDA tensors with grad enabled and an input that requires
grad, ``ssd_chunked`` (and ``ssd_scan``) go through ``_SSDChunkedFn``:
its forward is the same single launch, it saves ``x, dt, A, B, C``, and
its backward runs the hand-written kernels of
``csrc/ssd_scan_backward.cu`` through ``ssd_scan_backward``, with no
atomics (repeats are bitwise).  bfloat16: a state kernel writes the
state entering and the state's gradient leaving every 64-step tile, a
tile kernel forms each tile's dx, ddt and dB, dC, dA parts on its own
for a block of ``backward_heads`` heads of one group (sharing B, C and
C·Bᵀ; tensor-core products, each float32 operand as two bf16 terms),
and a fixed-order sum adds the head blocks and tiles.  float32 runs the
same three steps with every product in 3xTF32 (C·Bᵀ formed per head:
its tile would not fit beside float32 operands).  Nothing of the
forward is kept for it, so serving's launches stay as they were, and the
split time axis needs no backward of its own.  It replaces XLA's
autodiff of the reference's ``_ssd_chunked``
(``src/repro/models/mamba2.py:85``); the Pallas kernel has no backward.
``ssd_scan_backward_plain`` is the same algebra in plain torch, for the
tests and the smoke script.  Under ``no_grad`` / ``inference_mode``, or
with no input that requires grad (serving), the call is one launch that
saves nothing.

Counters.  ``ssd_scan.launches`` counts the wrapper calls that launch
the forward kernel, one per call of either wrapper, however many kernel
launches a split call issues; ``ssd_scan.backward_launches`` the calls
that launch the backward (one per call, for its three kernels).

``meta`` tensors (the dry run) take the kernels' shape functions: y and
the final state, or the gradients, empty, counted in
``ssd_scan.meta_calls`` / ``meta_backward_calls`` and not as launches.
DTensors (a device mesh) go through ``local_map`` (``kernels._mesh``):
the batch stays sharded, the heads too where each rank's heads read its
own groups (one group: B and C replicated over the head shards, their
gradients summed across them), anything else is replicated first; A's
gradient is summed over the batch shards.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import Partial, Shard

from repro_torch.kernels._launch import (DTYPE_CODE, float_workspace,
                                         kernel_device, shape_only, sm_count)
from repro_torch.kernels._mesh import (head_placements, is_dtensor,
                                       local_call, remap)

__all__ = ["WIDTHS", "launchable", "ssd_chunked", "ssd_scan",
           "ssd_scan_plain", "ssd_scan_backward", "ssd_scan_backward_plain",
           "ssd_splits", "ssd_piece_states_plain", "ssd_combine_plain",
           "ssd_piece_plain", "backward_heads"]

# (head_dim, d_state) pairs the CUDA kernel is compiled for:
# mamba2-2.7b's, jamba-v0.1-52b's and their reduced configs'
WIDTHS = ((64, 128), (64, 16), (32, 16))
# time steps per tile of the bf16 kernel on a row longer than 32; a
# piece of a split row is a whole number of them
TILE = 64
# the split aims at this many blocks per SM
BLOCKS_PER_SM = 2
MAX_SPLITS = 16
# heads a block of the bf16 backward's tile kernel serves at most
MAX_BACKWARD_HEADS = 8

# per device: the split workspace (piece states and totals)
_WORK: Dict[torch.device, torch.Tensor] = {}


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B,S,nh,hd), dt (B,S,nh), A "
                         f"(nh,), B and C (B,S,g,ds); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}")
    b, s, nh, _ = x.shape
    g = B.shape[2]
    if (tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,)
            or B.shape[:2] != (b, s) or B.shape != C.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if g == 0 or nh % g:
        raise ValueError(f"{nh} heads do not group evenly over {g} groups")
    if x.dtype not in DTYPE_CODE or len({x.dtype, B.dtype, C.dtype}) != 1:
        raise ValueError(f"x, B and C must share a dtype, float32 or "
                         f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{[t.device for t in (x, dt, A, B, C)]}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version, on any device: the reference's
    ``_ssd_chunked`` in float32.  Returns y ``(B, S, nh, hd)`` and the
    final state ``(B, nh, hd, ds)``, both float32."""
    _check(x, dt, A, B, C, chunk)
    return _plain(x, dt, A, B, C, chunk, None)


def _plain(x, dt, A, B, C, chunk: int, h0: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan_plain`` from the state ``h0 (B, nh, hd, ds)`` (None:
    zero) instead of 0."""
    b, s0, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    rep = nh // g
    pad = (-s0) % chunk
    if pad:
        # identity steps: dt = 0 means no decay and no input
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s0 + pad) // chunk
    xc = x.reshape(b, nc, chunk, g, rep, hd).float()
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bc = B.reshape(b, nc, chunk, g, ds).float()
    Cc = C.reshape(b, nc, chunk, g, ds).float()

    cum = torch.cumsum(dtc * A, dim=2)                  # (b,nc,cs,nh)
    total = cum[:, :, -1]                               # (b,nc,nh)

    # intra-chunk dual form; the mask comes before exp, where j > i
    # would give exp of a positive number
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,nh)
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              -torch.inf))
    sc = torch.einsum("bnigd,bnjgd->bnijg", Cc, Bc)     # per group
    M = (sc[..., None] * L.reshape(b, nc, chunk, chunk, g, rep)
         * dtc.reshape(b, nc, 1, chunk, g, rep))
    y = torch.einsum("bnijgr,bnjgrd->bnigrd", M, xc)

    # each chunk's own state, then the recurrence over the chunks
    w = (dtc * torch.exp(total[:, :, None, :] - cum)).reshape(
        b, nc, chunk, g, rep, 1)
    states = torch.einsum("bncgs,bncgrd->bngrds", Bc, xc * w)
    h = (torch.zeros(b, g, rep, hd, ds, dtype=torch.float32,
                     device=x.device) if h0 is None
         else h0.float().reshape(b, g, rep, hd, ds))
    decay = torch.exp(total).reshape(b, nc, g, rep, 1, 1)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * decay[:, n] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                 # (b,nc,g,r,hd,ds)
    y = y + (torch.einsum("bncgs,bngrds->bncgrd", Cc, h_prev)
             * torch.exp(cum).reshape(b, nc, chunk, g, rep, 1))
    y = y.reshape(b, nc * chunk, nh, hd)[:, :s0]
    return y, h.reshape(b, nh, hd, ds)


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, B: torch.Tensor,
                            C: torch.Tensor, dy: torch.Tensor,
                            dh_end: Optional[torch.Tensor] = None,
                            chunk: int = 256
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_scan_plain``'s ``(y, h_S)`` against ``dy
    (B, S, nh, hd)`` and ``dh_end (B, nh, hd, ds)`` (None: zero), in
    plain torch and float32, written out as the backward kernel computes
    them: the state entering each chunk from the forward recurrence,
    then a reverse walk over the chunks carrying ``dh``, the gradient of
    the state leaving the chunk.  With ``cum`` the chunk's prefix sum of
    ``a = dt·A``, ``total`` its last value, ``L_ij = exp(cum_i - cum_j)``
    for ``j <= i`` (masked before the exp), ``S_ij = C_i·B_j``, ``P_ij =
    dy_i·x_j`` and ``w_j = exp(total - cum_j)·dt_j``, a chunk gives

    - ``dx_j = Σ_i S_ij L_ij dt_j dy_i + w_j dh B_j``;
    - ``dC_i = Σ_j P_ij L_ij dt_j B_j + exp(cum_i) dy_iᵀ h_in``;
    - ``dB_j = Σ_i P_ij L_ij dt_j C_i + w_j x_jᵀ dh``;
    - ``da_m``, the gradient of ``a_m`` (the reverse cumulative sum of
      the gradient of ``cum``), summed without cancellation: the pairs'
      ``Q_ij = S_ij L_ij P_ij dt_j`` over ``j < m <= i``, plus ``exp(cum_i)
      dy_i·(h_in C_i)`` over ``i >= m``, plus ``w_j x_j·(dh B_j)`` over
      ``j < m``, plus ``exp(total) <dh, h_in>``;
    - ``ddt_j = A·da_j + Σ_i S_ij L_ij P_ij + exp(total - cum_j) x_j·(dh
      B_j)``, and ``dA = Σ dt·da`` over batch and time;
    - ``dh ← exp(total)·dh + Σ_i exp(cum_i) dy_i ⊗ C_i`` for the chunk
      before.

    Steps past S are the reference's padding, dt = 0 identity steps,
    whose gradients are dropped.  Returns ``dx`` in x's dtype, ``ddt
    (B, S, nh)`` and ``dA (nh,)`` in float32, ``dB`` and ``dC (B, S, g,
    ds)`` in B's dtype (each rounded once); B and C's gradients are the
    sums over the heads of their group."""
    _check(x, dt, A, B, C, chunk)
    b, s0, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    rep = nh // g
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    pad = (-s0) % chunk
    nc = (s0 + pad) // chunk

    def chunks(t, heads: bool = False):
        # float32, padded with zeros to whole chunks, (b, nc, chunk, ...);
        # B and C repeated over the heads of their group
        t = t.float()
        if heads:
            t = t.repeat_interleave(rep, dim=2)
        t = F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
        return t.reshape((b, nc, chunk) + t.shape[2:])

    xc, dyc, Bc, Cc = chunks(x), chunks(dy), chunks(B, True), chunks(C, True)
    dtc = chunks(dt)                                    # (b,nc,cs,nh)
    A = A.float()
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1]                               # (b,nc,nh)
    w = dtc * torch.exp(total[:, :, None] - cum)        # (b,nc,cs,nh)

    # the state entering each chunk, as the forward carries it
    h = torch.zeros(b, nh, hd, ds, dtype=torch.float32, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = (h * torch.exp(total[:, n])[..., None, None]
             + torch.einsum("bjhd,bjhs->bhds", xc[:, n] * w[:, n, ..., None],
                            Bc[:, n]))

    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    dh = (torch.zeros_like(h) if dh_end is None
          else dh_end.float().reshape(b, nh, hd, ds))
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xc, dtc, Bc, Cc))
    dA = torch.zeros(nh, dtype=torch.float32, device=x.device)
    for n in reversed(range(nc)):
        xn, dyn, Bn, Cn = xc[:, n], dyc[:, n], Bc[:, n], Cc[:, n]
        dtn, cn, tn, wn, hn = dtc[:, n], cum[:, n], total[:, n], w[:, n], \
            h_in[n]
        # (b, i, j, nh); the mask before exp
        L = torch.exp(torch.where(tri, cn[:, :, None] - cn[:, None], -torch.inf))
        Sij = torch.einsum("bihs,bjhs->bijh", Cn, Bn)
        Pij = torch.einsum("bihd,bjhd->bijh", dyn, xn)
        K = Sij * L * Pij
        E = Pij * L * dtn[:, None]
        dhB = torch.einsum("bjhs,bhds->bjhd", Bn, dh)
        dyh = torch.einsum("bihd,bhds->bihs", dyn, hn)
        ecum = torch.exp(cn)
        dx[:, n] = (torch.einsum("bijh,bihd->bjhd", Sij * L * dtn[:, None], dyn)
                    + wn[..., None] * dhB)
        dC[:, n] = torch.einsum("bijh,bjhs->bihs", E, Bn) + ecum[..., None] * dyh
        dB[:, n] = (torch.einsum("bijh,bihs->bjhs", E, Cn)
                    + wn[..., None] * torch.einsum("bjhd,bhds->bjhs", xn, dh))
        v = torch.exp(tn[:, None] - cn) * (xn * dhB).sum(-1)     # (b,j,nh)
        # da_m, the reverse cumulative sum of dcum, summed without
        # cancellation: the pairs' terms with j < m <= i, the read-out
        # terms from m on, the state terms before m and exp(total)
        # <dh, h_in>
        q = K * dtn[:, None]
        pairs = ((torch.cumsum(q, 2) - q) * tri).sum(1)     # (b,m,nh)
        r = ecum * (dyh * Cn).sum(-1)
        u = dtn * v
        da = (pairs + r.flip(1).cumsum(1).flip(1) + (u.cumsum(1) - u)
              + (torch.exp(tn) * (dh * hn).sum((-2, -1)))[:, None])
        ddt[:, n] = A * da + K.sum(1) + v
        dA += (dtn * da).sum((0, 1))
        dh = (torch.exp(tn)[..., None, None] * dh
              + torch.einsum("bihd,bihs->bhds", dyn * ecum[..., None], Cn))

    def unchunk(t):
        return t.reshape((b, nc * chunk) + t.shape[3:])[:, :s0]

    def grouped(t):
        return unchunk(t).reshape(b, s0, g, rep, ds).sum(3).to(B.dtype)

    return (unchunk(dx).to(x.dtype), unchunk(ddt), dA, grouped(dB),
            grouped(dC))


def ssd_splits(b: int, s: int, nh: int, sms: int) -> Tuple[int, int]:
    """``(splits, piece)`` for the bf16 kernel on ``b`` rows of ``s``
    steps and ``nh`` heads on a card with ``sms`` SMs: enough pieces that
    the ``(nh, b, splits)`` grid gives every SM about ``BLOCKS_PER_SM``
    blocks, but no more than the row has tiles nor ``MAX_SPLITS``;
    ``piece`` is a whole number of ``TILE``-step tiles, and ``splits``
    pieces of it cover the row, none of them wholly past its end.  From
    the shapes only: no device read."""
    tiles = max(1, -(-s // TILE))
    want = -(-BLOCKS_PER_SM * sms // max(1, b * nh))
    splits = max(1, min(want, tiles, MAX_SPLITS))
    piece = -(-tiles // splits) * TILE
    return max(1, -(-s // piece)), piece


def ssd_piece_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           piece: int, chunk: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the split kernel's state pass computes, in plain torch: for
    each piece of ``piece`` steps (the last one cut at S), its own final
    state from zero, ``(splits, B, nh, hd, ds)``, and its total sum of
    dt·A, ``(splits, B, nh)``; float32."""
    _check(x, dt, A, B, C, chunk)
    s = x.shape[1]
    states, totals = [], []
    for k in range(0, max(s, 1), piece):
        sl = slice(k, min(s, k + piece))
        states.append(_plain(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl],
                             chunk, None)[1])
        totals.append((dt[:, sl].float() * A).sum(dim=1))
    return torch.stack(states), torch.stack(totals)


def ssd_combine_plain(states: torch.Tensor,
                      totals: torch.Tensor) -> torch.Tensor:
    """The kernel's combine, in piece order: the state each piece starts
    from, ``h_in[0] = 0`` and ``h_in[k] = h_in[k-1]·exp(total[k-1]) +
    local[k-1]``; ``(splits, B, nh, hd, ds)``."""
    h = torch.zeros_like(states[0])
    h_in = []
    for local, total in zip(states, totals):
        h_in.append(h)
        h = h * torch.exp(total)[..., None, None] + local
    return torch.stack(h_in)


def ssd_piece_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, h_in: torch.Tensor,
                    chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the split kernel's second pass computes for one piece (x,
    dt, B and C cut to its steps), in plain torch: its y and its final
    state, from the state ``h_in (B, nh, hd, ds)``; float32."""
    _check(x, dt, A, B, C, chunk)
    return _plain(x, dt, A, B, C, chunk, h_in)


def launchable(x, dt, A, B, C) -> None:
    """Raise unless the CUDA kernel takes these (checked) inputs: head
    and state widths it is built for, contiguous x, dt and A, B and C in
    one layout whose (g, ds) axes are packed, and, in bf16, rows of x, B
    and C that start 16-byte aligned (float32 rows that do not are copied
    by the launch: ``_aligned_f32``)."""
    b, s, nh, hd = x.shape
    ds = B.shape[3]
    if (hd, ds) not in WIDTHS:
        raise ValueError(f"the CUDA ssd_scan is built for (head_dim, "
                         f"d_state) in {WIDTHS}, got {(hd, ds)}")
    if not (x.is_contiguous() and dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("the CUDA ssd_scan takes contiguous x, dt and A")
    # the kernel reads B and C at b·stride(0) + t·stride(1) + grp·ds + s
    # (a stride of an axis of size 1 is never used)
    want = [B.stride(0), B.stride(1), ds, 1]
    for t in (B, C):
        if any(n > 1 and st != w
               for n, st, w in zip(t.shape, t.stride(), want)):
            raise ValueError(f"the CUDA ssd_scan takes B and C with one "
                             f"layout and packed (g, ds) axes, got "
                             f"strides {B.stride()} and {C.stride()}")
    if x.dtype == torch.bfloat16 and any(_misaligned(t) for t in (x, B, C)):
        raise ValueError("the bf16 CUDA ssd_scan copies rows of x, B and C "
                         "16 bytes at a time: their data and their batch "
                         "and time strides must be 16-byte aligned")
    if max(b, nh) > 65535 or s >= 1 << 31:
        raise ValueError(f"shape {tuple(x.shape)} too large for one launch")


def _misaligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s data, or its batch or time stride, is not a whole
    number of 16-byte chunks."""
    per = 16 // t.element_size()
    return bool(t.data_ptr() % 16 or any(
        n > 1 and st % per for n, st in zip(t.shape[:2], t.stride()[:2])))


def _aligned_f32(x, B, C):
    """float32 x, B and C with rows the kernels can copy 16 bytes at a
    time: a copy of x, or of B and C together (they share one layout),
    where ``_misaligned``; bf16 inputs as they are (``launchable``
    refuses such rows)."""
    if x.dtype != torch.float32:
        return x, B, C
    if _misaligned(x):
        x = x.clone(memory_format=torch.contiguous_format)
    if _misaligned(B) or _misaligned(C):
        B, C = (t.clone(memory_format=torch.contiguous_format)
                for t in (B, C))
    return x, B, C


def _workspace(dev: torch.device, floats: int) -> torch.Tensor:
    """This kernel's split workspace on ``dev`` (``_WORK``)."""
    return float_workspace(_WORK, dev, floats)


def _launch(x, dt, A, B, C, y, h_out) -> None:
    from repro_torch.kernels._build import library

    x, B, C = _aligned_f32(x, B, C)
    launchable(x, dt, A, B, C)
    b, s, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    splits, piece, ws = 1, max(s, 1), None
    if x.dtype == torch.bfloat16:
        splits, piece = ssd_splits(b, s, nh, sm_count(x.device))
        if splits > 1:
            # each piece's state and total, but the last one's
            ws = _workspace(x.device,
                            (splits - 1) * b * nh * (hd * ds + 1)).data_ptr()
    fn = library("ssd_scan").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), int(y.dtype == torch.float32),
                 None if h_out is None else h_out.data_ptr(), ws, b, s, nh,
                 g, hd, ds, DTYPE_CODE[x.dtype], B.stride(0), B.stride(1),
                 piece, splits, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")


def backward_heads(b: int, s: int, nh: int, g: int, sms: int) -> int:
    """Heads a block of the backward's tile kernel serves: the most,
    up to ``MAX_BACKWARD_HEADS``, that divide a group's ``nh // g`` heads
    while the ``(nh / heads, tiles, b)`` grid still gives each of ``sms``
    SMs ``BLOCKS_PER_SM`` blocks; 1 when none does.  From the shapes
    only: no device read."""
    tiles = max(1, -(-s // TILE))
    rep = nh // g
    for hpb in range(min(MAX_BACKWARD_HEADS, rep), 0, -1):
        if rep % hpb == 0 and (nh // hpb) * tiles * b >= BLOCKS_PER_SM * sms:
            return hpb
    return 1


def _launch_backward(x, dt, A, B, C, dy, dh_end, dx, ddt, dA, dB,
                     dC) -> None:
    from repro_torch.kernels._build import library

    x, B, C = _aligned_f32(x, B, C)
    if dy.data_ptr() % 16:
        dy = dy.clone()
    launchable(x, dt, A, B, C)
    b, s, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    tiles = -(-s // TILE)
    # transient: the state entering each tile and the gradient of the
    # state leaving it, and the partials of dB, dC (a head block's) and
    # dA (a (batch row, tile)'s) before the fixed-order sums
    f32 = dict(dtype=torch.float32, device=x.device)
    hpb = backward_heads(b, s, nh, g, sm_count(x.device))
    states = torch.empty(b * nh * tiles * hd * ds, **f32)
    dstates = torch.empty_like(states)
    db_part = torch.empty(b * s * (nh // hpb) * ds, **f32)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty(b * nh * tiles, **f32)
    fn = library("ssd_scan_backward").ssd_scan_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), dy.data_ptr(),
                 None if dh_end is None else dh_end.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), states.data_ptr(),
                 dstates.data_ptr(),
                 db_part.data_ptr(), dc_part.data_ptr(), da_part.data_ptr(),
                 b, s, nh, g, hd, ds, DTYPE_CODE[x.dtype], hpb, B.stride(0),
                 B.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                      dh_end: Optional[torch.Tensor] = None,
                      chunk: int = 256) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC)``, the gradients of ``ssd_chunked``'s ``(y,
    h_S)`` against ``dy (B, S, nh, hd)`` and ``dh_end (B, nh, hd, ds)``
    (None: zero): ``dx`` in x's dtype, ``ddt`` and ``dA`` float32, ``dB``
    and ``dC`` contiguous in B's dtype.  The backward kernels of
    ``csrc/ssd_scan_backward.cu`` on CUDA tensors (one count of
    ``ssd_scan.backward_launches``; they walk 64-step tiles whatever
    ``chunk`` is), the plain version on CPU tensors."""
    _check(x, dt, A, B, C, chunk)
    if tuple(dy.shape) != tuple(x.shape) or (
            dh_end is not None and tuple(dh_end.shape)
            != (x.shape[0], x.shape[2], x.shape[3], B.shape[3])):
        raise ValueError(f"dy must be {tuple(x.shape)} and dh_end "
                         f"{(x.shape[0], x.shape[2], x.shape[3], B.shape[3])}"
                         f", got {tuple(dy.shape)} and "
                         f"{None if dh_end is None else tuple(dh_end.shape)}")
    if not kernel_device(x, "ssd_scan"):
        return ssd_scan_backward_plain(x, dt, A, B, C, dy, dh_end, chunk)
    dy = dy.to(torch.float32).contiguous()
    if dh_end is not None:
        dh_end = dh_end.to(torch.float32).contiguous()
    b, s, nh, _ = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    ddt = torch.empty(b, s, nh, dtype=torch.float32, device=x.device)
    dA = torch.zeros(nh, dtype=torch.float32, device=x.device)
    dB = torch.empty(B.shape, dtype=B.dtype, device=x.device)
    dC = torch.empty(C.shape, dtype=C.dtype, device=x.device)
    if b == 0 or s == 0 or shape_only(ssd_scan, x, dx, dB, backward=True,
                                      ops=2 * _ops(x, B)):
        return dx, ddt, dA, dB, dC
    _launch_backward(x, dt, A, B, C, dy, dh_end, dx, ddt, dA, dB, dC)
    ssd_scan.backward_launches += 1
    return dx, ddt, dA, dB, dC


class _SSDChunkedFn(torch.autograd.Function):
    """B5 under autograd: the forward kernel as serving runs it, the
    saved ``x, dt, A, B, C``, and the backward kernels, which recompute
    the states the forward carried."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.set_materialize_grads(False)
        y, h = _forward(x, dt, A, B, C)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_end):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_backward(x, dt, A, B, C, dy, dh_end, ctx.chunk)
        return (*(g if t.requires_grad else None
                  for g, t in zip(grads, (x, dt, A, B, C))), None)


def _ops(x, B) -> float:
    """B5's forward operation count on these shapes: the recurrence's two
    products (x ⊗ B into the state, the state against C), two flops a
    multiply-add, a step and head; the backward does twice as many."""
    b, s, nh, hd = x.shape
    return 4.0 * b * s * nh * hd * B.shape[3]


def _forward(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """One counted launch: y and the final state, both float32."""
    b, _, nh, hd = x.shape
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    h = torch.empty(b, nh, hd, B.shape[3], dtype=torch.float32,
                    device=x.device)
    if not shape_only(ssd_scan, x, y, h, ops=_ops(x, B)):
        _launch(x, dt, A, B, C, y, h)
        ssd_scan.launches += 1
    return y, h


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's SSD: y ``(B, S, nh, hd)`` and the final state ``(B,
    nh, hd, ds)``, both float32.  The plain version for CPU tensors,
    which autograd differentiates as it is.  On CUDA tensors the kernel:
    with grad enabled and an input that requires grad, through
    ``_SSDChunkedFn`` (the backward runs the backward kernels);
    otherwise one launch that saves nothing, as serving runs it."""
    if is_dtensor(x):
        return _on_mesh(x, dt, A, B, C, chunk)
    _check(x, dt, A, B, C, chunk)
    if not kernel_device(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if _needs_grad(x, dt, A, B, C):
        return _SSDChunkedFn.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """The reference kernel's API: y ``(B, S, nh, hd)`` in x's dtype,
    without the final state; under grad on CUDA tensors through
    ``ssd_chunked``'s autograd route."""
    if is_dtensor(x):
        return _on_mesh(x, dt, a, bmat, cmat, chunk)[0].to(x.dtype)
    _check(x, dt, a, bmat, cmat, chunk)
    if not kernel_device(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk)[0].to(x.dtype)
    if _needs_grad(x, dt, a, bmat, cmat):
        return ssd_chunked(x, dt, a, bmat, cmat, chunk)[0].to(x.dtype)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not shape_only(ssd_scan, x, y, ops=_ops(x, bmat)):
        _launch(x, dt, a, bmat, cmat, y, None)
        ssd_scan.launches += 1
    return y


def _on_mesh(x, dt, A, B, C, chunk: int):
    """B5 on DTensors: ``local_map`` over x, dt, A, B, C (see the module's
    docstring for the placements), returning (y, h) as DTensors."""
    nh, g = x.shape[2], B.shape[2]
    pl = head_placements(
        x, 2, lambda n: g == 1 or (nh % n == 0 and g % n == 0))
    pa = remap(pl, {2: 0})
    pbc = pl if g > 1 else remap(pl, {0: 0})
    # the gradients each rank returns for its replicated inputs are sums
    # over its own rows (A) or its own heads (B and C of one group)
    ga = [Partial() if p == Shard(0) else q for p, q in zip(pl, pa)]
    gbc = [Partial() if p == Shard(2) and g == 1 else q
           for p, q in zip(pl, pbc)]

    def fn(x, dt, A, B, C):
        return ssd_chunked(x, dt, A, B, C, chunk)

    return local_call(fn, x.device_mesh, (pl, pl, pa, pbc, pbc),
                      (pl, remap(pl, {0: 0, 2: 1})), x, dt, A, B, C,
                      out_shapes=(x.shape, (x.shape[0], nh, x.shape[3],
                                            B.shape[3])),
                      in_grad_placements=(pl, pl, ga, gbc, gbc))


ssd_scan.launches = 0
ssd_scan.backward_launches = 0
ssd_scan.meta_calls = 0
ssd_scan.meta_backward_calls = 0
