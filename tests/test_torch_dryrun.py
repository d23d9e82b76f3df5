"""The port's dry run (``repro_torch.launch.dryrun``): the step on
``meta`` DTensors over a fake process group of 256 / 512 ranks, against
the bytes the reference's partition specs give.

The reference's own dry run is not imported here: ``repro.launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices at import, which would slow every
later JAX test on the same worker.  Its rules are: ``repro.launch.
sharding`` on ``jax.eval_shape`` trees, each dimension of a leaf over
the product of its axes' sizes.  The decode and train records are made
under ``_as_torch_2_11``, the DTensor restriction of the card's torch.
"""
import contextlib
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as RefP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_shd
from repro.models import registry as ref_reg
from repro.models import transformer as ref_tfm
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _ref_bytes(shapes, specs, mesh):
    """Bytes a device holds of ``shapes`` (a pytree of ShapeDtypeStructs)
    placed by the reference's ``specs``: each dimension over the product
    of its axes' sizes."""
    leaves = jax.tree.leaves(shapes)
    flat = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    assert len(leaves) == len(flat)
    total = 0
    for leaf, spec in zip(leaves, flat):
        axes = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for dim, axis in zip(leaf.shape, axes):
            names = (() if axis is None else
                     axis if isinstance(axis, tuple) else (axis,))
            size = int(np.prod([mesh[a] for a in names])) if names else 1
            assert dim % size == 0
            n *= dim // size
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _ref_args(cfg, shape_name, mesh):
    """The reference dry run's arguments and their specs."""
    rmesh = SimpleNamespace(shape=dict(mesh), axis_names=tuple(mesh))
    shape = REF_SHAPES[shape_name]
    params = jax.eval_shape(
        lambda: ref_tfm.init_params(cfg, jax.random.PRNGKey(0)))
    pspecs = ref_shd.param_specs(cfg, params, rmesh)
    inputs = ref_reg.input_specs(cfg, shape)
    ispecs = ref_shd.input_spec_tree(cfg, shape, rmesh, inputs)
    if shape.kind == "train":
        opt = jax.eval_shape(ref_opt.init_state, params)
        ospecs = type(opt)(step=RefP(), mu=pspecs, nu=pspecs)
        return (params, opt, inputs), (pspecs, ospecs, ispecs)
    return (params, inputs), (pspecs, ispecs)


@contextlib.contextmanager
def _as_torch_2_11():
    """DTensor as the card's torch 2.11 has it, as far as the port
    depends on it: 2.11 refuses to flatten a sharded dimension that is
    not the leading one, where this host's 2.13 makes a ``_StridedShard``
    placement; any such placement here raises, as 2.11 would.  2.11 has
    no sharding strategy for the in-place ``index_put_``; none is
    registered here either (this host's DTensor still runs it where every
    input is replicated, which 2.11 refuses too)."""
    import torch
    from torch.distributed.tensor import DTensor, _dtensor_spec
    from torch.distributed.tensor.placement_types import _StridedShard

    init = _dtensor_spec.DTensorSpec.__post_init__

    def strict(self):
        if any(isinstance(p, _StridedShard) for p in self.placements):
            raise RuntimeError(f"a _StridedShard: {self.placements}")
        init(self)

    prop = DTensor._op_dispatcher.sharding_propagator
    aten = torch.ops.aten
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_dtensor_spec.DTensorSpec, "__post_init__", strict)
        mp.delitem(prop.op_single_dim_strategy_funcs,
                   aten.index_put_.default, raising=False)
        prop.propagate_op_sharding.cache_clear()
        try:
            yield
        finally:
            prop.propagate_op_sharding.cache_clear()


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    """``main`` as a user runs it: qwen1.5-0.5b at decode_32k on both
    meshes, appended to ``--out``."""
    out = tmp_path_factory.mktemp("dryrun") / "records.jsonl"
    with _as_torch_2_11():
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(out)])
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_main_prints_two_ok_records(decode_records, capsys):
    assert [(r["mesh"], r["ok"]) for r in decode_records] == \
        [("16x16", True), ("2x16x16", True)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_decode_bytes_equal_the_reference_specs(decode_records, multi_pod):
    rec = decode_records[int(multi_pod)]
    mesh = MESHES[multi_pod]
    args, specs = _ref_args(ref_config("qwen1.5-0.5b"), "decode_32k", mesh)
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_bytes(args, specs, mesh)
    cache = rec["memory"]["cache_size_in_bytes"]
    assert cache * (512 if multi_pod else 256) == \
        rec["memory"]["cache_total_bytes"]
    assert cache == _ref_bytes(args[1]["cache"], specs[1]["cache"], mesh)
    # every layer's decode attention went through its shape function,
    # and the ranks merged their partials across the sequence shards
    assert rec["kernels"] == {"decode_attention": 24}
    assert rec["collectives_by_axis"]["model"]["all-reduce"] > 0


@pytest.fixture(scope="module")
def train_probe():
    """train_4k at a 2-layer probe of qwen1.5-0.5b's full width."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=2)
    with _as_torch_2_11():
        return dryrun.run_one("qwen1.5-0.5b", "train_4k", False, cfg=cfg)


def test_train_probe_bytes_equal_the_reference_specs(train_probe):
    assert train_probe["ok"], train_probe.get("traceback")
    cfg = dataclasses.replace(ref_config("qwen1.5-0.5b"), num_layers=2)
    args, specs = _ref_args(cfg, "train_4k", MESHES[False])
    assert train_probe["memory"]["argument_size_in_bytes"] == \
        _ref_bytes(args, specs, MESHES[False])


def test_train_probe_reduces_gradients_over_the_data_axis(train_probe):
    data = train_probe["collectives_by_axis"]["data"]
    assert data.get("all-reduce", 0) + data.get("reduce-scatter", 0) > 0
    # B3 forward (and its remat recompute) and backward, shapes only
    assert train_probe["kernels"]["flash_attention"] >= 3 * 2
    assert train_probe["flops"] > 0


def test_run_cost_extrapolates_a_full_run_exactly():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=3)
    cost = dryrun.run_cost("qwen1.5-0.5b", "decode_32k", False, cfg=cfg)
    full = dryrun.run_one("qwen1.5-0.5b", "decode_32k", False, cfg=cfg)
    assert cost["ok"] and full["ok"]
    assert (cost["probe_repeats"], cost["full_repeats"]) == ([1, 2], 3)
    assert cost["flops"] == full["flops"]
    assert cost["collectives"] == full["collectives"]


def test_run_one_restores_the_hint_variables(monkeypatch):
    monkeypatch.delenv("REPRO_SHARD_HEADS_AXIS", raising=False)
    monkeypatch.setenv("REPRO_SHARD_SEQ_AXIS", "")
    dryrun.run_one("olmoe-1b-7b", "decode_32k", True)
    assert "REPRO_SHARD_HEADS_AXIS" not in os.environ
    assert os.environ["REPRO_SHARD_SEQ_AXIS"] == ""
