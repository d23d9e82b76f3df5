"""A new cell, configuration, traffic mix or per-layer metric is picked up
from its own new file, with no file that was there edited."""
import hashlib
import json
import shutil
import time

from gpubench.lib import catalog
from gpubench.tests import tiny

NEW_METRIC = '''"""A metric a later change adds: the window's batch count."""
UNIT = "batches"


def read(ctx):
    return float(len(ctx.batches))
'''


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_cell_a_config_and_a_metric(tmp_path):
    root = tmp_path / "gpubench"
    shutil.copytree(catalog.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(root)
    (root / "configs" / "tiny-moe.json").write_text(
        json.dumps(tiny.config(tiny.MOE, torch_dtype="bfloat16")))
    (root / "traffic" / "tiny-generate.json").write_text(
        json.dumps(tiny.traffic("generate", gen_tokens=2)))
    cell = tiny.cell("tiny-moe", "tiny-generate")
    del cell["name"]
    (root / "workloads" / "tiny-moe-generate.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "batches_served.py").write_text(NEW_METRIC)
    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    # BENCHMARK.json gains entries for them; none of its entries changes
    bench = json.loads((catalog.HERE.parent / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "batches_served",
                               "workloads": ["tiny-moe-generate"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = catalog.cell("tiny-moe-generate", root)
    cfg = catalog.config(found["config"], root)
    traffic = catalog.traffic(found["traffic"], root)
    assert cfg["n_routed_experts"] == 8 and traffic["gen_tokens"] == 2
    assert catalog.per_layer("tiny-moe-generate", root) == ["batches_served"]
    drv = catalog.driver(found["driver"], root)
    out = drv.run(found, cfg, traffic, seed=3, seconds=0.6, trace=True,
                  t_start=time.perf_counter(), device="cpu", strict=False,
                  root=root)
    assert out["metrics"]["batches_served"]["value"] >= 1
    assert out["metrics"]["batches_served"]["unit"] == "batches"
    assert out["attempted"] == 36 and out["failed"] == 0


def test_benchmark_json_picks_the_cells_metrics(tmp_path):
    root = tmp_path / "gpubench"
    root.mkdir()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [{"name": "latency_mean_ms"},
                       {"name": "tokens_per_s", "workloads": ["other"]}],
        "per_layer": [{"name": "queue_wait_ms"},
                      {"name": "moe_share_pct", "workloads": ["a"]}]}))
    assert catalog.end_to_end("a", root) == ["latency_mean_ms"]
    assert catalog.per_layer("a", root) == ["queue_wait_ms", "moe_share_pct"]
    assert catalog.per_layer("b", root) == ["queue_wait_ms"]
