"""Multi-pod dry run: run every (arch × shape × mesh) combo's step on the
``meta`` device over a fake process group of 256 or 512 ranks.

Port of the reference package's ``repro.launch.dryrun``, which lowers
and compiles the real step functions on 512 placeholder host devices.
Here the production mesh (``launch.mesh.make_production_mesh``) is built
over ``torch.distributed``'s fake process group (every collective a
no-op), the model, its AdamW state and the abstract inputs
(``models.registry.input_specs``) are placed by the sharding rules
(``launch.sharding``) as ``meta`` DTensors, and the step itself runs
(``train.loop.make_train_step(remat=True, microbatches=
REPRO_MICROBATCH)``, ``transformer.prefill`` or ``decode_step``), its
hand kernels through their shape functions under ``local_map``.  Nothing
is allocated and nothing is computed: a combo that runs proves that the
placements are coherent, op by op.

Each record (one JSON line, with ``--out`` appended to a file) keeps the
reference's keys where they have a meaning:

- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes`` a
  device, from the local shard shapes of the parameters, the optimizer
  state and the inputs, and of what the step returns; at a decode shape
  also the cache's bytes a device and in all;
- ``flops``: the step's flops a device as
  ``torch.utils.flop_counter``'s formulas count the local ops (a
  dispatch mode under DTensor, so each op is counted on its local
  shapes), plus the hand kernels' own operation counts, which their
  shape functions report (``meta_ops``) since they do no arithmetic;
- ``collectives``: output bytes a device of each kind ("all-reduce",
  "all-gather", "reduce-scatter", "all-to-all"), from the same dispatch
  mode over the ``_c10d_functional`` ops DTensor issues, with
  ``collective_counts`` beside them and ``collectives_by_axis`` split by
  the mesh axis each ran over;
- ``kernels``: the hand kernels' shape-function calls;
- ``ok``, ``error``, ``traceback``, ``total_s``.

XLA's ``temp_size_in_bytes``, ``generated_code_size_in_bytes``,
``bytes_accessed``, ``transcendentals``, ``lower_s`` and ``compile_s``
have no counterpart (nothing is lowered or compiled) and are left out.
The mesh runs on the "cpu" device type, where DTensor turns an
all-to-all into an all-gather and a chunk; the fake group's rank is 0, so
where DTensor chunks a dimension unevenly (qwen1.5-4b's 20 heads over
16) the bytes are rank 0's, the largest shard.

Every arch of the registry runs: the dense and SSM families, MoE
(OLMoE; its groups of tokens whole on each rank, the experts over
"model"), MLA (DeepSeek-V2-Lite; decode merges each rank's partials over
its slice of the latent cache), the hybrid (Jamba), the enc-dec
(whisper; its cross cache keeps its heads over "model") and the VLM
(InternVL2; ``train_4k`` feeds its patch embeddings).

``REPRO_SHARD_HEADS_AXIS`` and ``REPRO_SHARD_SEQ_AXIS`` default to
"model" inside ``main`` and ``run_one`` (the reference sets them at
import), and are restored on return.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape decode_32k --mesh both [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import distribute as dst
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as reg
from repro_torch.models import transformer as tfm
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, AdamWState, init_state

__all__ = ["fake_group", "build_lowerable", "run_one", "run_cost", "main"]

_HINTS = ("REPRO_SHARD_HEADS_AXIS", "REPRO_SHARD_SEQ_AXIS")
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor":
          "all-gather", "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
_KERNELS = {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "decode_attention_int8": decode_attention_int8,
            "ssd_scan": ssd_scan,
            "mla_decode_attention": mla_decode_attention}


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A fake process group of ``world`` ranks (this process is rank 0),
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _shard_hints() -> Iterator[None]:
    """The reference dry run's layout hints (§Perf T1, T3) by default,
    restored on exit."""
    saved = {k: os.environ.get(k) for k in _HINTS}
    for k in _HINTS:
        os.environ.setdefault(k, "model")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Count(TorchDispatchMode):
    """Flops of the local ops (``torch.utils.flop_counter``'s formulas)
    and the collectives' output bytes, by kind and by mesh axis.  An op
    on DTensors is left to DTensor (``NotImplemented``), which dispatches
    its local ops back here; the FakeTensor ops of DTensor's shape
    propagation run uncounted."""

    def __init__(self, axes: Dict[str, str]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.axes = axes
        self.flops = 0
        self.bytes: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.by_axis: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) or t.__name__ ==
               "AsyncCollectiveTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        kind = (_KINDS.get(func._opname)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            n = out.numel() * out.element_size()
            self.bytes[kind] = self.bytes.get(kind, 0) + n
            self.counts[kind] = self.counts.get(kind, 0) + 1
            # the group's name is the op's last string argument
            group = [a for a in args if isinstance(a, str)][-1]
            axis = self.by_axis.setdefault(self.axes.get(group, "other"),
                                           {})
            axis[kind] = axis.get(kind, 0) + n
        return out


def build_lowerable(arch: str, shape_name: str, mesh,
                    cfg: Optional[ModelConfig] = None
                    ) -> Tuple[Any, Tuple, Tuple]:
    """Returns ``(fn, args, specs)``: the step function, its abstract
    (``meta``, unplaced) arguments and their partition specs."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    window = reg.decode_window(cfg, shape)
    inputs = reg.input_specs(cfg, shape)
    model = tfm.abstract_params(cfg)
    pspecs = shd.param_specs(cfg, model, mesh)
    ispecs = shd.input_spec_tree(cfg, shape, mesh, inputs)

    if shape.kind == "train":
        opt = AdamWConfig(total_steps=1000)
        step = make_train_step(
            cfg, opt, remat=True,
            microbatches=int(os.environ.get("REPRO_MICROBATCH", "1")))
        mspecs = dst.moment_specs(model, pspecs, mesh)
        return step, (model, init_state(model), inputs), (pspecs, mspecs,
                                                          ispecs)
    if shape.kind == "prefill":
        def fn(params, batch):
            return tfm.prefill(cfg, params, batch, shape.seq_len,
                               window=window)
        return fn, (model, inputs), (pspecs, ispecs)

    def fn(params, tokens, cache, lengths):
        return tfm.decode_step(cfg, params, tokens, cache, lengths,
                               window=window)
    return fn, (model, inputs["tokens"], inputs["cache"],
                inputs["lengths"]), (pspecs, ispecs["tokens"],
                                     ispecs["cache"], ispecs["lengths"])


def _place(arg, spec, mesh):
    """``arg`` (a model, an AdamW state, an input dict, a cache list or a
    tensor) placed on ``mesh`` by ``spec``."""
    if isinstance(arg, nn.Module):
        return dst.shard_model(arg, mesh, spec)
    if isinstance(arg, AdamWState):
        return dst.shard_opt_state(arg, mesh, spec)
    if isinstance(arg, dict):
        return {k: _place(v, spec[k], mesh) for k, v in arg.items()}
    if isinstance(arg, list):
        return dst.shard_cache(arg, mesh, spec)
    return dst.distribute(arg, mesh, spec)


def _local_bytes(obj) -> int:
    """Bytes one device holds of ``obj``'s tensors (DTensors: the local
    shard)."""
    if isinstance(obj, nn.Module):
        return sum(_local_bytes(p) for p in obj.parameters())
    if isinstance(obj, dict):
        return sum(_local_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_local_bytes(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        t = obj.to_local() if dst.is_dtensor(obj) else obj
        return t.numel() * t.element_size()
    return 0


def _total_bytes(obj) -> int:
    if isinstance(obj, (list, tuple)):
        return sum(_total_bytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(_total_bytes(v) for v in obj.values())
    return obj.numel() * obj.element_size()


def _kernel_state() -> Dict[str, Tuple[int, float]]:
    return {n: (getattr(f, "meta_calls", 0)
                + getattr(f, "meta_backward_calls", 0),
                getattr(f, "meta_ops", 0.0)) for n, f in _KERNELS.items()}


def _fold_spec(spec):
    """A spec of the 3-D mesh on its folded 2-D view: the ("pod", "data")
    pair, always together in the rules and major first, becomes the
    view's "data"."""
    if isinstance(spec, dict):
        return {k: _fold_spec(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_fold_spec(v) for v in spec]
    if not isinstance(spec, shd.PartitionSpec):
        return tuple(_fold_spec(v) for v in spec)
    out = []
    for axis in spec:
        if isinstance(axis, tuple) and "pod" in axis:
            if axis[:2] != ("pod", "data"):
                raise ValueError(f"spec {spec}: 'pod' without 'data' after "
                                 f"it")
            axis = ("data",) + axis[2:]
            axis = axis[0] if len(axis) == 1 else axis
        elif axis == "pod":
            raise ValueError(f"spec {spec}: 'pod' without 'data' after it")
        out.append(axis)
    return shd.P(*out)


def _fold_pod(mesh, specs):
    """The (2, 16, 16) mesh's step runs on its (32, 16) view: the same
    ranks in the same order with "pod" and "data" folded into one
    dimension, and the specs folded alike, so every device holds the same
    shard.  DTensor's sharding propagation on the 3-D mesh spends minutes
    a layer planning redistributions (it plans through a graph search
    wherever a flattened batch and sequence give a ``_StridedShard``);
    its suggestion, too, is to flatten the mesh.  A 2-D mesh is kept."""
    names = tuple(mesh.mesh_dim_names)
    if names != ("pod", "data", "model"):
        return mesh, specs
    pod, data, model = mesh.shape
    view = init_device_mesh(mesh.device_type, (pod * data, model),
                            mesh_dim_names=("data", "model"))
    view.axis_labels = ("pod+data", "model")
    return view, _fold_spec(specs)


def _run(arch: str, shape_name: str, mesh,
         cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The step on ``mesh``'s meta DTensors: memory, flops, collectives
    and kernel calls a device."""
    fn, args, specs = build_lowerable(arch, shape_name, mesh, cfg=cfg)
    mesh, specs = _fold_pod(mesh, specs)
    placed = tuple(_place(a, s, mesh) for a, s in zip(args, specs))
    memory = {"argument_size_in_bytes": _local_bytes(placed)}
    if SHAPES[shape_name].kind == "decode":
        memory["cache_size_in_bytes"] = _local_bytes(placed[2])
        memory["cache_total_bytes"] = _total_bytes(args[2])
    axes = {mesh.get_group(i).group_name: name
            for i, name in enumerate(getattr(mesh, "axis_labels",
                                             mesh.mesh_dim_names))}
    before = _kernel_state()
    grad = SHAPES[shape_name].kind == "train"
    with _Count(axes) as count, dst.step_scope(mesh), \
            torch.set_grad_enabled(grad):
        out = fn(*placed)
    memory["output_size_in_bytes"] = _local_bytes(out)
    after = _kernel_state()
    return {
        "memory": memory,
        "flops": float(count.flops)
        + sum(after[n][1] - before[n][1] for n in _KERNELS),
        "collectives": dict(count.bytes),
        "collective_counts": dict(count.counts),
        "collectives_by_axis": count.by_axis,
        "kernels": {n: after[n][0] - before[n][0] for n in _KERNELS
                    if after[n][0] > before[n][0]},
    }


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _fail(rec: Dict[str, Any], e: Exception) -> None:
    rec["ok"] = False
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-2000:]


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One combo at full depth (or at ``cfg``, e.g. a depth probe)."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod)}
    t0 = time.time()
    try:
        with _shard_hints(), fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            rec.update(_run(arch, shape_name, mesh, cfg))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001
        _fail(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _probe_cfg(cfg: ModelConfig, repeats: int) -> ModelConfig:
    """Full-width config with `lead + repeats*period` layers (and a
    matching-depth encoder) — used for layer-linear cost extrapolation."""
    lead, p, r = tfm.split_pattern(cfg)
    kw: Dict[str, Any] = {"num_layers": lead + repeats * p}
    if cfg.encoder is not None and cfg.encoder.num_layers > 0:
        per = cfg.encoder.num_layers // r
        kw["encoder"] = dataclasses.replace(cfg.encoder,
                                            num_layers=per * repeats)
    return dataclasses.replace(cfg, **kw)


def run_cost(arch: str, shape_name: str, multi_pod: bool, *,
             cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Layer-linear cost model: probe with 1 and 2 repeats, extrapolate
    flops and collective bytes to the full depth (of ``cfg`` when
    given)."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod), "kind": "cost"}
    t0 = time.time()
    try:
        cfg = cfg or get_config(arch)
        _, _, r = tfm.split_pattern(cfg)
        with _shard_hints(), fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            c1 = _run(arch, shape_name, mesh, _probe_cfg(cfg, 1))
            c2 = _run(arch, shape_name, mesh, _probe_cfg(cfg, 2))
        rec["probe_repeats"] = [1, 2]
        rec["full_repeats"] = r

        def extrap(a, b):
            return a + (r - 1) * (b - a)

        rec["flops"] = extrap(c1["flops"], c2["flops"])
        kinds = set(c1["collectives"]) | set(c2["collectives"])
        rec["collectives"] = {
            k: int(max(0, extrap(c1["collectives"].get(k, 0),
                                 c2["collectives"].get(k, 0))))
            for k in kinds}
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001
        _fail(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cost", action="store_true",
                    help="probe-extrapolated cost model instead of the "
                         "full-depth memory dry-run")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    with _shard_hints():
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = (run_cost if args.cost else run_one)(arch, shape,
                                                               mp)
                    line = json.dumps(rec)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(line + "\n")
                    short = {k: rec[k] for k in
                             ("arch", "shape", "mesh", "ok", "total_s")
                             if k in rec}
                    if rec["ok"]:
                        short["flops"] = f"{rec['flops']:.3e}"
                        if "memory" in rec:
                            short["arg_gb"] = round(
                                rec["memory"]["argument_size_in_bytes"]
                                / 2**30, 3)
                    else:
                        short["error"] = rec.get("error", "")[:200]
                    print(json.dumps(short), flush=True)


if __name__ == "__main__":
    main()
