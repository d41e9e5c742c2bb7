"""The harness end to end on the CPU at tiny sizes: every cell runs and is
correct, its control is not, a new mix runs as a new file alone, the
command refuses to run without a card or without the program, and
nothing the benchmark loads is JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import discovery, harness, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = tiny.with_held(discovery.Benchmark(ROOT))
CELLS = SPEC.workload_names()


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    line = tiny.run(name, root=ROOT, seconds=2.0)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    cell = SPEC.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line = tiny.run(name, root=ROOT, control=torch.bfloat16)
    assert line["checks"]["answers"]["value"] >= 1
    assert not line["correct"], line["checks"]


def test_a_new_mix_runs_as_a_file_of_its_own(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    mix = {"jobs": ["w2.count_partitioned", "w4.index_join.sorted"],
           "keys": {"kind": "zipf", "exponent": 0.5}}
    (root / "bench" / "traffic" / "mixed2.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": "paper-w.mixed2", "config": "paper-w",
                              "traffic": "mixed2", "chips": 1,
                              "why": "W2 and W4 in turn"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "paper-w.agg" in m.get("workloads", []):
            m["workloads"].append("paper-w.mixed2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = tiny.run("paper-w.mixed2", root=str(root), seconds=2.0,
                    spec=discovery.Benchmark(str(root)))
    assert line["correct"] and line["metrics"]["rows_per_s"]["value"] > 0
    assert line["checks"]["rel_gap.join"]["value"] < 1e-5


def run_command(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1",
                           *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_command(ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_command_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_command(str(tmp_path), env=env)
    assert out.returncode != 0 and out.stdout == ""


NO_JAX = r"""
import sys, torch
sys.path[:0] = [{src!r}, {root!r}]
import bench.reference.tpch, bench.reference.paper_w
ref_loads = sorted({{m.split('.')[0] for m in sys.modules}} & {{'repro_torch', 'repro', 'jax'}})
from bench import discovery, harness, tiny
spec = discovery.Benchmark({root!r})
for m in spec.spec['per_layer']:
    spec.metric(m['name'])
for name in spec.workload_names():
    tiny.run(name, root={root!r}, seconds=0.2, spec=spec)
print(ref_loads, harness.forbidden_modules())
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = NO_JAX.format(src=os.path.join(ROOT, "src"), root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.analytics", "numpy"]) == []
    assert harness.forbidden_modules(["repro.analytics", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
