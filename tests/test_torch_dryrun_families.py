"""The port's dry run (``repro_torch.launch.dryrun``) for the MoE, MLA,
hybrid, enc-dec and VLM families: OLMoE, DeepSeek-V2-Lite, Jamba,
whisper-medium and InternVL2, on ``meta`` DTensors over a fake process
group of 256 / 512 ranks.

- ``decode_32k`` at full depth on both meshes: every record ``ok``, the
  argument and cache bytes a device equal to the reference's partition
  specs', the cache split over every rank, one decode kernel shape call
  per attention (whisper: its self and its cross attention; DeepSeek:
  MLA decode, whose ranks merge their partials over "model").
- ``train_4k`` at a probe of one repeat of each stack at full width
  (``dryrun._probe_cfg``): ``ok``, the argument bytes equal to the
  reference specs' (parameters, AdamW moments and inputs: the VLM's
  patch embeddings, whisper's frames), gradients reduced over "data";
  the MoE families' collectives recorded by kind and mesh axis.

The records are made under ``_as_torch_2_11``, the DTensor restriction
of the card's torch (``tests/test_torch_dryrun.py``).
"""
import dataclasses

import pytest
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from test_torch_dryrun import MESHES, _as_torch_2_11, _ref_args, _ref_bytes

FAMILIES = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
            "whisper-medium", "internvl2-1b"]


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def decode_records():
    with _as_torch_2_11():
        return {(arch, mp): dryrun.run_one(arch, "decode_32k", mp)
                for arch in FAMILIES for mp in (False, True)}


def _decode_kernels(arch):
    """The decode kernels' shape-function calls of one step: one per
    attention layer (MLA's own kernel on DeepSeek), and whisper's cross
    attention beside its self attention."""
    cfg = get_config(arch)
    n = cfg.layer_kinds().count("attn")
    if cfg.mla is not None:
        return {"mla_decode_attention": n}
    if cfg.family == "audio":
        n *= 2
    return {"decode_attention": n}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_bytes_equal_the_reference_specs(decode_records, arch,
                                                multi_pod):
    rec = decode_records[arch, multi_pod]
    assert rec["ok"], rec.get("traceback")
    mesh = MESHES[multi_pod]
    args, specs = _ref_args(ref_config(arch), "decode_32k", mesh)
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_bytes(args, specs, mesh)
    cache = rec["memory"]["cache_size_in_bytes"]
    assert cache * (512 if multi_pod else 256) == \
        rec["memory"]["cache_total_bytes"]
    assert cache == _ref_bytes(args[1]["cache"], specs[1]["cache"], mesh)
    assert rec["kernels"] == _decode_kernels(arch)
    if arch == "deepseek-v2-lite-16b":
        # each rank's partials over its slice of the latent cache, merged
        assert rec["collectives_by_axis"]["model"]["all-reduce"] > 0


def _probe_pair(arch):
    """The port's one-repeat probe config and the reference config cut
    alike."""
    cfg = dryrun._probe_cfg(get_config(arch), 1)
    ref = dataclasses.replace(ref_config(arch), num_layers=cfg.num_layers)
    if cfg.encoder is not None and cfg.encoder.num_layers > 0:
        ref = dataclasses.replace(ref, encoder=dataclasses.replace(
            ref.encoder, num_layers=cfg.encoder.num_layers))
    return cfg, ref


@pytest.fixture(scope="module")
def train_probes():
    out = {}
    with _as_torch_2_11():
        for arch in FAMILIES:
            cfg, _ = _probe_pair(arch)
            out[arch] = dryrun.run_one(arch, "train_4k", False, cfg=cfg)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_probe_bytes_equal_the_reference_specs(train_probes, arch):
    rec = train_probes[arch]
    assert rec["ok"], rec.get("traceback")
    _, ref = _probe_pair(arch)
    args, specs = _ref_args(ref, "train_4k", MESHES[False])
    assert rec["memory"]["argument_size_in_bytes"] == \
        _ref_bytes(args, specs, MESHES[False])
    data = rec["collectives_by_axis"]["data"]
    assert data.get("all-reduce", 0) + data.get("reduce-scatter", 0) > 0
    assert rec["flops"] > 0
    if get_config(arch).moe is not None:
        # the experts over "model": their collectives recorded by kind
        assert set(rec["collectives_by_axis"]["model"]) <= {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all"}
        assert rec["collectives_by_axis"]["model"]
