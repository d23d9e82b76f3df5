"""The port's sharding rules (``repro_torch.launch.sharding``), the
registry's abstract inputs and ``transformer.abstract_params`` against
the reference's ``repro.launch.sharding`` and ``repro.models.registry``,
rule by rule, with no process group.

A port layer is one module where the reference stacks its repeated
layers: reference repeat ``i`` of ``stack[j]`` is port layer ``lead +
i·p + j``, so a port layer's spec must be the reference's at its stacked
path with the leading stack ``None`` dropped (the cache's likewise).
The mesh is a shape, as the reference's ``mesh16()`` is.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.configs import reduced as ref_reduced
from repro.launch import sharding as ref_shd
from repro.models import registry as ref_reg
from repro.models import transformer as ref_tfm
from repro_torch.configs import SHAPES, get_config, list_archs, reduced
from repro_torch.launch import sharding as shd
from repro_torch.models import registry as reg
from repro_torch.models import transformer as tfm

ARCHS = list_archs()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_mesh(shape):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@functools.lru_cache(maxsize=None)
def _ref_params_shape(arch):
    cfg = ref_config(arch)
    return jax.eval_shape(lambda: ref_tfm.init_params(cfg,
                                                      jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return tfm.abstract_params(get_config(arch))


def _ref_path(cfg, name):
    """(path into the reference's parameter tree, stacked) of a port
    parameter name."""
    keys = name.split(".")
    lead, p, _ = tfm.split_pattern(cfg)
    if keys[0] == "layers":
        i = int(keys[1])
        if i < lead:
            return ["lead", i] + keys[2:], False
        return ["stack", (i - lead) % p] + keys[2:], True
    if keys[:2] == ["encoder", "layers"]:
        return ["encoder", "stack"] + keys[3:], True
    return keys, False


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _unstack(spec, stacked):
    spec = tuple(spec)
    return spec[1:] if stacked else spec


# ---------------------------------------------------------------------------
# the divisibility guard (the reference's TestGuards cases)
# ---------------------------------------------------------------------------

GUARD_CASES = [
    (MESHES["16x16"], (None, "model"), (10, 32)),
    (MESHES["16x16"], (None, "model"), (10, 20)),
    (MESHES["2x16x16"], (("pod", "data"), None), (64, 7)),
    (MESHES["2x16x16"], (("pod", "data"), None), (48, 7)),
    (MESHES["2x16x16"], (("data",), "model"), (32, 32)),
    (MESHES["16x16"], (("data", "model"), None), (512, 3)),
]


@pytest.mark.parametrize("mesh,spec,shape", GUARD_CASES)
def test_guard_equals_the_reference(mesh, spec, shape):
    got = shd._guard(spec, shape, mesh)
    want = ref_shd._guard(spec, shape, _ref_mesh(mesh))
    assert tuple(got) == tuple(want)
    assert isinstance(got, shd.PartitionSpec)


def test_guard_normalises_a_one_axis_tuple():
    assert shd._guard((("data",), None), (32, 3), MESHES["16x16"]) == \
        shd.P("data", None)


# ---------------------------------------------------------------------------
# parameter specs: every parameter of every arch on both meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    ref = ref_shd.param_specs(ref_config(arch), _ref_params_shape(arch),
                              _ref_mesh(mesh))
    cfg = get_config(arch)
    got = shd.param_specs(cfg, _abstract(arch), mesh)
    assert set(got) == {n for n, _ in _abstract(arch).named_parameters()}
    for name, spec in got.items():
        path, stacked = _ref_path(cfg, name)
        assert tuple(spec) == _unstack(_at(ref, path), stacked), name


def test_param_specs_take_a_device_mesh_or_a_mapping():
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    cfg = get_config("qwen1.5-0.5b")
    assert shd.param_specs(cfg, _abstract("qwen1.5-0.5b"), mesh) == \
        shd.param_specs(cfg, _abstract("qwen1.5-0.5b"), MESHES["16x16"])


def test_qwen4b_head_fallback():
    """20 heads don't divide 16: the projections shard head_dim."""
    specs = shd.param_specs(get_config("qwen1.5-4b"), _abstract("qwen1.5-4b"),
                            MESHES["16x16"])
    assert specs["layers.0.attn.wq"] == shd.P(None, None, "model")
    assert specs["layers.0.attn.wo"] == shd.P(None, "model", None)
    assert specs["layers.0.attn.bq"] == shd.P(None, "model")


def test_olmoe_expert_parallel():
    specs = shd.param_specs(get_config("olmoe-1b-7b"),
                            _abstract("olmoe-1b-7b"), MESHES["16x16"])
    assert specs["layers.0.ffn.w_gate"] == shd.P("model", None, None)
    assert specs["layers.0.ffn.w_down"] == shd.P("model", None, None)
    assert specs["layers.0.ffn.router"] == shd.P(None, None)


def test_zero1_opt_specs_equal_the_reference_rule():
    """Per parameter: the reference's rule on the layer's own shape; and
    where the reference's stacked moment did not take its repeat axis,
    the reference's spec itself with the stack dropped."""
    for arch in ARCHS:
        cfg = get_config(arch)
        mesh = MESHES["16x16"]
        rmesh = _ref_mesh(mesh)
        pshape = _ref_params_shape(arch)
        rspecs = ref_shd.param_specs(ref_config(arch), pshape, rmesh)
        rzero = ref_shd.zero1_opt_specs(pshape, rspecs, rmesh)
        specs = shd.param_specs(cfg, _abstract(arch), mesh)
        got = shd.zero1_opt_specs(_abstract(arch), specs, mesh)
        for name, spec in got.items():
            path, stacked = _ref_path(cfg, name)
            leaf = _at(pshape, path)
            shape = leaf.shape[1:] if stacked else leaf.shape
            one = ref_shd.zero1_opt_specs(
                {"x": jax.ShapeDtypeStruct(shape, leaf.dtype)},
                {"x": RefP(*_unstack(_at(rspecs, path), stacked))},
                rmesh)["x"]
            assert tuple(spec) == tuple(one), (arch, name)
            ref = tuple(_at(rzero, path))
            if not stacked or ref[0] != "data":
                assert tuple(spec) == _unstack(ref, stacked), (arch, name)


def test_zero1_on_mamba2_differs_where_the_reference_takes_the_repeats():
    """mamba2-2.7b stacks 64 layers: the reference's moments shard their
    repeat axis over 'data'; a port layer has no such axis."""
    pshape = _ref_params_shape("mamba2-2.7b")
    rmesh = _ref_mesh(MESHES["16x16"])
    rz = ref_shd.zero1_opt_specs(
        pshape, ref_shd.param_specs(ref_config("mamba2-2.7b"), pshape,
                                    rmesh), rmesh)
    assert tuple(rz["stack"][0]["ssm"]["A_log"])[0] == "data"
    cfg = get_config("mamba2-2.7b")
    specs = shd.param_specs(cfg, _abstract("mamba2-2.7b"), MESHES["16x16"])
    got = shd.zero1_opt_specs(_abstract("mamba2-2.7b"), specs,
                              MESHES["16x16"])
    assert got["layers.0.ssm.A_log"] == shd.P("data")     # 80 heads / 16


# ---------------------------------------------------------------------------
# abstract inputs and their specs
# ---------------------------------------------------------------------------

def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rcfg, rshape = ref_config(arch), REF_SHAPES[shape_name]
    assert reg.token_len(cfg, shape) == ref_reg.token_len(rcfg, rshape)
    assert reg.decode_window(cfg, shape) == ref_reg.decode_window(rcfg,
                                                                   rshape)
    got = reg.input_specs(cfg, shape)
    want = ref_reg.input_specs(rcfg, rshape)
    assert set(got) == set(want)
    for k, v in got.items():
        if k == "cache":
            continue
        assert v.device.type == "meta"
        assert (tuple(v.shape), _dtype_name(v)) == \
            (tuple(want[k].shape), str(want[k].dtype)), k
    if "cache" in got:
        lead, p, _ = tfm.split_pattern(cfg)
        for i, layer in enumerate(got["cache"]):
            ref = (want["cache"]["lead"][i] if i < lead
                   else want["cache"]["stack"][(i - lead) % p])
            assert set(layer) == set(ref), i
            for n, t in layer.items():
                rs = ref[n].shape if i < lead else ref[n].shape[1:]
                assert (tuple(t.shape), _dtype_name(t)) == \
                    (tuple(rs), str(ref[n].dtype)), (i, n)
                assert t.device.type == "meta"


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_spec_tree_equals_the_reference(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    inputs = reg.input_specs(cfg, shape)
    rinputs = ref_reg.input_specs(ref_config(arch), REF_SHAPES[shape_name])
    lead, p, _ = tfm.split_pattern(cfg)
    for mesh in MESHES.values():
        got = shd.input_spec_tree(cfg, shape, mesh, inputs)
        want = ref_shd.input_spec_tree(ref_config(arch),
                                       REF_SHAPES[shape_name],
                                       _ref_mesh(mesh), rinputs)
        for k, spec in got.items():
            if k != "cache":
                assert tuple(spec) == tuple(want[k]), k
                continue
            for i, layer in enumerate(spec):
                ref = (want["cache"]["lead"][i] if i < lead
                       else want["cache"]["stack"][(i - lead) % p])
                for n, s in layer.items():
                    assert tuple(s) == _unstack(ref[n], i >= lead), (i, n)


def test_decode_cache_d1_layout():
    """Batch over data, the cache sequence over model."""
    cfg = get_config("qwen1.5-0.5b")
    inp = reg.input_specs(cfg, SHAPES["decode_32k"])
    specs = shd.input_spec_tree(cfg, SHAPES["decode_32k"], MESHES["16x16"],
                                inp)
    assert specs["cache"][0]["k"] == shd.P("data", "model", None, None)
    assert specs["tokens"] == shd.P("data", None)
    multi = shd.input_spec_tree(cfg, SHAPES["decode_32k"],
                                MESHES["2x16x16"], inp)
    assert multi["cache"][5]["v"] == shd.P(("pod", "data"), "model", None,
                                           None)


def test_long500k_sequence_over_both_axes_in_mesh_order():
    cfg = get_config("qwen1.5-0.5b")
    inp = reg.input_specs(cfg, SHAPES["long_500k"])
    specs = shd.input_spec_tree(cfg, SHAPES["long_500k"], MESHES["16x16"],
                                inp)
    k = specs["cache"][0]["k"]
    assert k[0] is None and k[1] == ("data", "model")
    multi = shd.input_spec_tree(cfg, SHAPES["long_500k"], MESHES["2x16x16"],
                                inp)
    assert multi["cache"][0]["k"][1] == ("pod", "data", "model")


def test_to_placements_pins_the_major_first_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    assert shd.to_placements(shd.P(None, ("data", "model"), None, None),
                             mesh) == [Shard(1), Shard(1)]
    assert shd.to_placements(shd.P("model", None), mesh) == [Replicate(),
                                                             Shard(0)]
    assert shd.to_placements(shd.P(), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        shd.to_placements(shd.P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.to_placements(shd.P("model", "model"), mesh)
    pod = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.to_placements(shd.P(("pod", "data"), None), pod) == \
        [Shard(0), Shard(0), Replicate()]


# ---------------------------------------------------------------------------
# abstract parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_init_params(arch):
    cfg = reduced(get_config(arch))
    real = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    meta = tfm.abstract_params(cfg)
    got = {n: (tuple(p.shape), p.dtype, p.device.type)
           for n, p in meta.named_parameters()}
    want = {n: (tuple(p.shape), p.dtype, "meta")
            for n, p in real.named_parameters()}
    assert got == want


def test_abstract_params_hold_no_memory_at_full_size():
    meta = tfm.abstract_params(get_config("mamba2-2.7b"))
    n = sum(p.numel() for p in meta.parameters())
    assert n > 2.8e9
    assert all(p.device.type == "meta" for p in meta.parameters())


def test_reference_archs_are_the_ports():
    assert sorted(ARCHS) == sorted(ref_archs())
    for arch in ARCHS:
        r, p = ref_reduced(ref_config(arch)), reduced(get_config(arch))
        assert (r.num_layers, r.d_model) == (p.num_layers, p.d_model)
    assert np.all([SHAPES[s].seq_len == REF_SHAPES[s].seq_len
                   for s in SHAPES])
