"""The harness finds every configuration, traffic mix, family and metric
by name from files; a new cell, configuration or metric is new files and
new entries, never an edit; without a card the command prints no
result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]


def test_every_entry_resolves_to_its_files():
    spec = H.bench_spec()
    names = [c["name"] for c in spec["configs"]]
    for cell in spec["workloads"]:
        cfg, traffic = H.cell_files(spec, cell)
        assert cfg["name"] == cell["config"] in names
        assert traffic["batch"] > 0
        fam = H.family_class(cfg)
        assert fam.metric in {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert callable(H.metric_reader(m["name"]))
        assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}


def test_benchmark_json_follows_its_shape():
    spec = H.bench_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in spec["workloads"]:
        assert len(cell["why"]) <= 200 and cell["chips"] == 1
    layers = {m["name"].split(".")[0]: m["layer"] for m in spec["per_layer"]}
    for m in spec["per_layer"]:
        assert m["layer"] == layers[m["name"].split(".")[0]]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """In a copy of the benchmark, a new traffic mix, a new cell and a new
    per-layer metric are found from their new files and entries alone."""
    for item in ("benchmark", "BENCHMARK.json"):
        src = ROOT / item
        (shutil.copytree if src.is_dir() else shutil.copy)(
            src, tmp_path / item)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/traffic/closed_b16.json").write_text(json.dumps(
        {"loop": "closed", "batch": 16, "start_noise": 0.05,
         "check_episodes_per_rollout": 4}))
    (tmp_path / "benchmark/metrics/wall_s.py").write_text(
        "def read(summary):\n    return summary.get('wall_s')\n")
    spec["workloads"].append({"name": "unicycle_mc_sweep.b16",
                              "config": "unicycle_mc_sweep",
                              "traffic": "closed_b16", "chips": 1,
                              "why": "a test's cell"})
    spec["per_layer"].append({"name": "wall_s.unicycle", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "rollout loop",
                              "moves": "unicycle_steps_per_s",
                              "workloads": ["unicycle_mc_sweep.b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from benchmark import harness as H; s = H.bench_spec(); "
            "c = H.find_cell(s, 'unicycle_mc_sweep.b16'); "
            "cfg, tr = H.cell_files(s, c); "
            "print(tr['batch'], H.metric_reader('wall_s.unicycle')("
            "{'wall_s': 2.5}), H.family_class(cfg).metric)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["16", "2.5", "unicycle_steps_per_s"]


def test_no_card_no_result():
    """On a machine without CUDA the command fails and prints nothing on
    standard output (it never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         H.bench_spec()["workloads"][0]["name"], "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr
