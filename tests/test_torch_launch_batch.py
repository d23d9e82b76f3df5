"""ROADMAP C-R6: the launcher's batches for the audio and VLM families.

The reference's ``repro.launch.train`` feeds tokens and labels only, so
on whisper its encoder finds no ``frames`` (``KeyError``); the port's
launcher gives an audio model the reference trainer's float32 zero
frames (``train.loop.device_batch``), and keeps the VLM on tokens and
labels as the reference's launcher runs it.
"""
import sys

import numpy as np
import pytest
import torch

from repro.launch import train as ref_launch_train
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tfm
from repro_torch.train.data import DataConfig, SyntheticCorpus
from repro_torch.train.loop import device_batch, make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_state

ARGS = ["--arch", "whisper-medium", "--reduced", "--steps", "1",
        "--batch", "2", "--seq", "32"]


def _corpus_batch(cfg, batch: int = 2, seq: int = 32):
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch))
    return next(iter(data.batches()))


def test_reference_launcher_has_no_frames_for_whisper(monkeypatch):
    """The reference's own fault, pinned: its launcher's batch lacks the
    encoder's frames."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + ARGS)
    with pytest.raises(KeyError, match="frames"):
        ref_launch_train.main()


def test_port_launcher_trains_whisper_on_zero_frames():
    """One step of reduced whisper-medium through ``run``; its first loss
    bitwise equal to one ``make_train_step`` on ``device_batch`` of the
    same corpus batch from the same seeded weights."""
    out = launch_train.run(launch_train.parse_args(ARGS), device="cpu",
                           log=False)
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    cfg = reduced(get_config("whisper-medium"))
    model = tfm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    step = make_train_step(cfg, AdamWConfig(total_steps=1, warmup_steps=1))
    jb = device_batch(cfg, _corpus_batch(cfg), "cpu")
    assert jb["frames"].dtype == torch.float32
    assert not jb["frames"].any()
    _, _, m = step(model, init_state(model), jb)
    assert float(m["loss"]) == out["losses"][0]


@pytest.mark.parametrize("arch,keys", [
    ("whisper-medium", {"tokens", "labels", "frames"}),
    ("internvl2-1b", {"tokens", "labels"}),
    ("qwen1.5-0.5b", {"tokens", "labels"}),
])
def test_launch_batch_keys(arch, keys):
    """The audio model gets zero frames of ``(B, n_ctx, d)``; the VLM no
    ``patch_embeds`` (the reference's launcher feeds its text alone);
    a text model tokens and labels, int64."""
    cfg = reduced(get_config(arch))
    jb = launch_train.launch_batch(cfg, _corpus_batch(cfg), "cpu")
    assert set(jb) == keys
    assert jb["tokens"].dtype == jb["labels"].dtype == torch.int64
    if "frames" in jb:
        assert tuple(jb["frames"].shape) == (2, cfg.encoder.n_ctx,
                                             cfg.d_model)
