"""The control, the plain reference in the program's place with every
product's operands rounded to float8 e4m3, comes out not correct under
each cell's own limits, while the program on the same batches passes
them: on the CPU at a test's size (16 layers of 256, 64-token prompts),
as ``calibrate.py`` reads it on the chip at the cells' sizes."""
import pytest
import torch

from gpubench import calibrate
from gpubench.lib import catalog
from gpubench.tests import tiny

CASES = {
    "phi4-prompt1k": (tiny.DENSE, tiny.traffic(prompt_len=64, b_max=8,
                                               rate=400.0)),
    "deepseek-prompt1k": (tiny.MOE, tiny.traffic(prompt_len=64, b_max=8,
                                                 rate=400.0)),
    "deepseek-doc2k": (tiny.MOE, tiny.traffic(
        "generate", prompt_len=64, gen_tokens=6, b_max=8, rate=200.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_fp8_control_fails_a_limit_the_program_meets(name):
    base, traffic = CASES[name]
    cell = dict(catalog.cell(name))
    cell["check"] = dict(cell["check"], requests=16)
    limits = cell["check"]["limits"]
    seeds = [2 ** 33 + 5, 7]
    out = calibrate.readings(cell, tiny.deep(base), traffic, seeds,
                             set(seeds), 0.1, torch.device("cpu"),
                             strict=False)
    for k, lim in limits.items():
        assert out["lower"][k] <= lim, (k, out)
    assert any(out["upper"][k] > lim for k, lim in limits.items()), out
