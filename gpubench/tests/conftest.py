import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def pytest_configure(config):
    import torch

    # a few threads a test process, as a benchmark run uses: test
    # processes side by side share the cores
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
