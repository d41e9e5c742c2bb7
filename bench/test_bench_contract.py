"""BENCHMARK.json against the rules a benchmark file must keep, and the
harness finding every piece of it by name; the same for the cells held
back under bench/held/."""
import json
import os
import re

import pytest

from bench import discovery, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module", params=["committed", "with held cells"])
def spec(request):
    """BENCHMARK.json, and BENCHMARK.json with the entries held back under
    bench/held/ added, which must keep the same rules."""
    b = discovery.Benchmark(ROOT)
    return tiny.with_held(b) if request.param != "committed" else b


def test_top_level_keys_and_command(spec):
    s = spec.spec
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["bench"]
    assert 1 <= len(s["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in s["command"])
    assert os.path.isfile(os.path.join(ROOT, s["command"][1]))
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entries_have_only_their_keys(spec):
    s = spec.spec
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_and_units(spec):
    s = spec.spec
    entries = s["configs"] + s["workloads"] + s["end_to_end"] + s["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[group]]
        assert len(names) == len(set(names))
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}


def test_every_cell_reports_what_it_must(spec):
    s = spec.spec
    configs = {c["name"] for c in s["configs"]}
    used = set()
    for w in s["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_are_named_alike(spec):
    by_layer = {}
    for m in spec.spec["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_configs_are_found_by_name_and_state_their_cuts(spec):
    for c in spec.spec["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(spec.path("runners", f"{cfg['runner']}.py"))
        assert set(cfg["limits"]) == {"rel_gap", "mismatches"}
        assert all(v >= 0 for v in cfg["limits"]["rel_gap"].values())
        assert cfg["limits"]["mismatches"] == 0
        assert cfg["assumed"]


def test_mixes_and_metrics_are_found_by_name(spec):
    for w in spec.spec["workloads"]:
        assert isinstance(spec.traffic(w["traffic"]), dict)
    for m in spec.spec["per_layer"]:
        mod = spec.metric(m["name"])
        assert (mod.NAME, mod.UNIT, mod.MOVES, mod.SOURCE, mod.LAYER) == (
            m["name"], m["unit"], m["moves"], m["source"], m["layer"])
        assert mod.read({}) is None


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(os.path.join(ROOT, "bench")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_chip_time_of_a_full_check_fits(spec):
    n = 24
    runs = 2 + 14 * n
    total = runs * (spec.spec["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200


def test_unknown_workload_is_refused(spec):
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_benchmark_json_is_plain_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.load(f)
