"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package); ``repro_torch`` passes."""
import subprocess
import sys

from gpubench.lib import catalog

ROOT = catalog.HERE.parent

SCRIPT = f"""
import sys, time
sys.argv = ["run.py"]
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import gpubench.run as run
from gpubench.lib import catalog
from gpubench.tests import tiny
drv = catalog.driver("serve")
for base, tr in ((tiny.DENSE, tiny.traffic()),
                 (tiny.MOE, tiny.traffic("generate", gen_tokens=2))):
    out = drv.run(tiny.cell(), tiny.config(base, torch_dtype="bfloat16"), tr,
                  seed=1, seconds=0.4, trace=True, t_start=time.perf_counter(),
                  device="cpu", strict=False)
assert "repro_torch" in sys.modules
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names():
    from gpubench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "reprox", "jaxtyping", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "flax",
                              "jaxlib"]) == ["flax", "jax", "jaxlib", "repro"]


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "phi4-prompt1k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
