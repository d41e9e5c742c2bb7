"""The port's cost-model calibration (``scripts/calibrate_costs_torch.py``
and ``repro_torch.analytics.dist_join_bench``) against the reference's
(``scripts/calibrate_costs.py``, ``repro.analytics.dist_join_bench``).

(a) The fits: both scripts get the same scripted timings (the reference's
``time_fn`` and ``benchmarks.common.run_in_mesh``, the port's
``dist_join_bench.bench_runs``, ``sweep`` and ``exchange``) and must
write the same profile, over the edge cases of each rule.

(b) The numbers fixed by the data, not by timing: the zipf overflow at
each capacity factor, the benchmarks' plan fields (cost picks, estimated
and observed moved rows, buffer sizes) and the telemetry refresh,
against the reference run once in a subprocess with 4 fake devices.

(c) A profile the port writes loads to equal fields in both packages, and
a profile that flips a decision gives both packages the same ``explain``.
"""
import importlib.util
import json
import os
import sys

import pytest
import torch

from conftest import run_with_devices
from repro.analytics import planner as RP
from repro.analytics import tpch as R
from repro_torch.analytics import dist_join_bench as DJB
from repro_torch.analytics import planner as TP
from repro_torch.analytics import tpch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)          # benchmarks.common, as the reference's
import benchmarks.common as bench_common  # noqa: E402

N_DEV = 4


def _load(name, filename):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("_ref_calibrate_costs", "calibrate_costs.py")
PORT = _load("_port_calibrate_costs", "calibrate_costs_torch.py")


@pytest.fixture(autouse=True)
def builtin_profiles():
    RP.set_cost_profile(None)
    TP.set_cost_profile(None)
    yield
    RP.set_cost_profile(None)
    TP.set_cost_profile(None)


# ---------------------------------------------------------------------------
# (a) the fits, on scripted timings
# ---------------------------------------------------------------------------
COLS = [1, 2, 3, 4, 6]
GROUPS = [64, 128, 256, 512, 1024, 2048]
BUILDS = [64, 256, 1024, 4096]
PROBES = [1024, 4096, 16384]
MORSELS = [256, 1024, 4096]
# each case: seconds of the base fit's xla(C) and dense(C) and the sort;
# dense-wins over GROUPS; the challenger's win at each point of the dist
# (partitioned), exchange (radix) and morsel (split) sweeps; the capacity
# factors tried on the zipf keys
CASES = {
    "crossover at the first point": dict(
        xla=[1.0, 1.5, 2.0, 2.5, 3.5], dense=[0.9, 1.0, 1.1, 1.2, 1.4],
        sort=0.7, dense_wins=[0, 0, 0, 0, 0, 0], wins=[1, 1, 1, 1],
        cfs=[1.0, 1.25, 1.5, 2.0, 3.0]),
    "no crossover": dict(
        xla=[2.0, 2.2, 2.4, 2.6, 3.0], dense=[0.5, 0.6, 0.7, 0.8, 1.0],
        sort=3.0, dense_wins=[1, 1, 1, 1, 1, 1], wins=[0, 0, 0, 0],
        cfs=[0.25, 0.5]),
    "one noisy loss": dict(
        xla=[1.0, 1.4, 1.9, 2.2, 3.1], dense=[1.5, 1.6, 1.8, 1.9, 2.3],
        sort=0.2, dense_wins=[1, 0, 1, 1, 0, 0], wins=[0, 1, 0, 1],
        cfs=[1.0, 2.0, 3.0]),
    "negative slope": dict(
        xla=[3.0, 2.5, 2.0, 1.5, 0.5], dense=[2.0, 1.5, 1.0, 0.9, 0.1],
        sort=0.1, dense_wins=[1, 1, 1, 1, 1, 0], wins=[0, 0, 1, 1],
        cfs=[3.0]),
}


def _scripted(case):
    """(timing seconds in call order, dist raw, exchange raw)."""
    base = [t * 1e-3 for t in case["xla"] + case["dense"] + [case["sort"]]]
    groups = []
    for i, won in enumerate(case["dense_wins"]):
        t = 1e-3 * (i + 1)
        groups += [t, t * 1.5] if won else [t * 1.5, t]
    morsel = []
    for i, won in enumerate(case["wins"][:len(MORSELS)]):
        t = 1e-3 * (i + 2)
        morsel += [t * 1.5, t] if won else [t, t * 1.5]
    dist = {str(b): {"broadcast": 100.0 * (i + 1),
                     "partitioned": 100.0 * (i + 1) * (0.5 if w else 2.0)}
            for i, (b, w) in enumerate(zip(BUILDS, case["wins"]))}
    ex = {str(p): {"argsort": 50.0 * (i + 1),
                   "radix": 50.0 * (i + 1) * (0.8 if w else 1.2),
                   "cost_picks": "argsort", "moved_rows": p}
          for i, (p, w) in enumerate(zip(PROBES, case["wins"]))}
    return base + groups + morsel, dist, ex


def _argv(case, out):
    return (["--rows", "16384", "--groups", "64", "--cols"]
            + [str(c) for c in COLS]
            + ["--sweep-groups", "--groups-sweep"] + [str(g) for g in GROUPS]
            + ["--capacity-factors"] + [str(c) for c in case["cfs"]]
            + ["--dist", "--dist-devices", str(N_DEV), "--dist-probe", "8192",
               "--dist-builds"] + [str(b) for b in BUILDS]
            + ["--exchange", "--exchange-build", "512", "--exchange-probes"]
            + [str(p) for p in PROBES]
            + ["--morsel", "--morsel-probes"] + [str(m) for m in MORSELS]
            + ["--out", out])


@pytest.mark.parametrize("name", sorted(CASES))
def test_fits_equal_reference_on_scripted_timings(name, tmp_path,
                                                  monkeypatch):
    case = CASES[name]
    times, dist, ex = _scripted(case)

    ref_times = iter(times)
    monkeypatch.setattr(REF, "time_fn", lambda fn, **kw: next(ref_times))
    monkeypatch.setattr(
        bench_common, "run_in_mesh",
        lambda code, **kw: ex if "exchange_impl" in code else dist)
    ref_out = str(tmp_path / "ref.json")
    monkeypatch.setattr(sys, "argv", ["calibrate_costs.py"]
                        + _argv(case, ref_out))
    REF.main()

    port_times = iter(times)
    monkeypatch.setattr(PORT.DJB, "bench_runs",
                        lambda fn, *a, **kw: [next(port_times)] * 5)
    monkeypatch.setattr(PORT.DJB, "sweep", lambda *a, **kw: dist)
    monkeypatch.setattr(PORT.DJB, "exchange", lambda *a, **kw: ex)
    port_out = str(tmp_path / "port.json")
    assert PORT.main(_argv(case, port_out) + ["--device", "cpu"]) == 0

    with open(ref_out) as f:
        want = json.load(f)
    with open(port_out) as f:
        got = json.load(f)
    assert next(ref_times, None) is None and next(port_times, None) is None
    runs = got["raw_us"].pop("xla_runs")
    assert runs == {str(c): [got["raw_us"]["xla"][str(c)]] * 5 for c in COLS}
    # scripted runs do not spread: one attempt at the baseline
    attempts = got.pop("base_attempts")
    assert len(attempts) == 1 and attempts[0]["spread_us"] == 0.0
    assert got == want
    # each case reaches the edge it is named for
    if name == "no crossover":
        assert got["partition_capacity_factor"] is None
        assert got["dense_group_limit"] == 4096
        assert got["morsel_split_rows"] == 2 * MORSELS[-1]
    if name == "crossover at the first point":
        assert got["dense_group_limit"] == GROUPS[0] - 1
        assert got["morsel_split_rows"] == MORSELS[0]
    if name == "one noisy loss":
        assert got["dense_group_limit"] == 512
    if name == "negative slope":
        assert got["pass_time_us"] == 0.001          # clamped at 1e-9 s
        assert got["fused_per_col"] >= 0.01 and got["fused_fixed"] >= 0.05


def test_fit_functions_hold_the_reference_arithmetic():
    assert PORT.crossover([(4, False), (16, True)]) == 8.0
    assert PORT.crossover([(4, True), (16, True)]) == 4.0
    assert PORT.crossover([(4, False), (16, False)]) == 32.0
    assert PORT.fit_dense_group_limit([(1, True), (2, False), (3, True)]) \
        == 4096                                # one noisy loss, no crossover
    assert PORT.fit_dense_group_limit([(1, True), (2, False), (3, False)]) \
        == 1
    assert PORT.fit_capacity_factor([(1.0, 5), (1.5, 0)]) == 1.875
    assert PORT.fit_capacity_factor([(1.0, 5)]) is None
    assert PORT.fit_morsel([(100, False), (400, True)]) == 200


# each attempt: the xla runs (ms) of every width; the slope is 1 ms a column
_FLAT, _WIDE = [10.0] * 5, [9.0, 9.5, 10.0, 11.5, 12.0]


@pytest.mark.parametrize("attempts, cleared", [
    ([[_FLAT] * 5], True),                        # at once
    ([[_WIDE] + [_FLAT] * 4, [_FLAT] * 5], True),  # C=1 spread 2 ms first
    ([[_WIDE] * 5] * PORT.BASE_ATTEMPTS, False),   # never: the last is kept
])
def test_baseline_is_measured_again_while_its_slope_is_inside_its_spread(
        monkeypatch, attempts, cleared):
    kept = len(attempts) - 1
    def xla(i, j):
        return [1e-3 * (t + COLS[j]) for t in attempts[i][j]]
    script = [xla(i, j) for i in range(len(attempts))
              for j in range(len(COLS))]
    script += [[1e-3]] * (len(COLS) + 1)           # dense widths, sort
    calls = iter(script)
    monkeypatch.setattr(PORT.DJB, "bench_runs",
                        lambda fn, *a, **kw: next(calls))
    got, _dense, _sort, tried = PORT.measure_base(
        256, 16, COLS, None, torch.device("cpu"))
    assert next(calls, None) is None
    assert got == {C: xla(kept, j) for j, C in enumerate(COLS)}
    assert len(tried) == len(attempts)
    for (slope, spread), att in zip(tried, attempts):
        assert slope == pytest.approx(1e-3)
        assert spread == pytest.approx(1e-3 * max(
            PORT.quartile_spread(r) for r in att))
    assert (tried[-1][0] > tried[-1][1]) == cleared
    assert all(slope <= spread for slope, spread in tried[:-1])


# ---------------------------------------------------------------------------
# (b) numbers fixed by the data
# ---------------------------------------------------------------------------
EX_BUILD, EX_PROBES = 1024, [1024, 8192]
PD_ROWS, PD_GROUPS = 4096, 64
CH_ROWS, CH_DIM = 4096, 256
TK_ROWS, TK_GROUPS, TK_K = 4096, 512, 8
DRIFTING_PROFILE = {"fused_fixed": 1.2, "fused_per_col": 0.45,
                    "backend": "cpu"}

REF_SCRIPT = r"""
import contextlib, importlib.util, io, json
from repro.analytics import dist_join_bench as D

# the benchmarks' plan fields only: one untimed call in place of bench
ONE_CALL = '''
import jax as _jax

def bench(fn, *args, iters=5):
    _jax.block_until_ready(fn(*args))
    return 0.0
'''


def run(code):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(compile(code.replace(D.BENCH_SNIPPET, ONE_CALL), "<bench>",
                     "exec"), {"__name__": "__bench__"})
    return json.loads(buf.getvalue().strip().splitlines()[-1])


out = {"exchange": run(D.exchange_code(build=EX_BUILD, probes=EX_PROBES,
                                       devices=N_DEV)),
       "pushdown": run(D.pushdown_code(rows=PD_ROWS, groups=PD_GROUPS,
                                       devices=N_DEV)),
       "chain": run(D.chain_code(rows=CH_ROWS, dim=CH_DIM, devices=N_DEV)),
       "topk": run(D.topk_code(rows=TK_ROWS, groups=TK_GROUPS, k=TK_K,
                               devices=N_DEV))}
spec = importlib.util.spec_from_file_location("ref_calib", SCRIPT)
calib = importlib.util.module_from_spec(spec)
spec.loader.exec_module(calib)
calib.refresh_from_telemetry(PROFILE, N_DEV)
with open(PROFILE) as f:
    out["refreshed"] = json.load(f)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_fields(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "profile.json")
    with open(path, "w") as f:
        json.dump(DRIFTING_PROFILE, f)
    consts = dict(EX_BUILD=EX_BUILD, EX_PROBES=EX_PROBES, PD_ROWS=PD_ROWS,
                  PD_GROUPS=PD_GROUPS, CH_ROWS=CH_ROWS, CH_DIM=CH_DIM,
                  TK_ROWS=TK_ROWS, TK_GROUPS=TK_GROUPS, TK_K=TK_K,
                  N_DEV=N_DEV, PROFILE=path,
                  SCRIPT=os.path.join(REPO, "scripts", "calibrate_costs.py"))
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    out = run_with_devices(head + REF_SCRIPT, n_devices=N_DEV, timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def untimed(monkeypatch):
    """dist_join_bench.bench as one untimed call (the plan fields only)."""
    monkeypatch.setattr(DJB, "bench", lambda fn, *a, **kw: (fn(*a), 0.0)[1])


def test_exchange_picks_and_moved_rows_equal_reference(ref_fields, untimed):
    got = DJB.exchange(EX_BUILD, EX_PROBES, N_DEV, "cpu")
    want = ref_fields["exchange"]
    assert sorted(got) == sorted(want)
    for p, row in want.items():
        assert got[p]["cost_picks"] == row["cost_picks"], p
        assert got[p]["moved_rows"] == row["moved_rows"], p
    assert {r["cost_picks"] for r in want.values()} == {"argsort", "radix"}


def test_pushdown_and_chain_plan_fields_equal_reference(ref_fields, untimed):
    pd = DJB.pushdown(PD_ROWS, PD_GROUPS, N_DEV, "cpu")
    ch = DJB.chain(CH_ROWS, CH_DIM, N_DEV, "cpu")
    for tag in ("pushdown", "no_pushdown"):
        assert pd[tag]["moved_rows"] == \
            ref_fields["pushdown"][tag]["moved_rows"], tag
    for tag in ("compact", "no_compact"):
        assert ch[tag]["max_buffer_rows"] == \
            ref_fields["chain"][tag]["max_buffer_rows"], tag


def test_topk_wire_fields_equal_reference(ref_fields, untimed):
    got = DJB.topk(TK_ROWS, TK_GROUPS, TK_K, N_DEV, "cpu")
    want = ref_fields["topk"]
    for key in ("moved_rows", "observed_moved", "cost_picks", "wire_budget"):
        assert got[key] == want[key], key


def test_refresh_rewrites_the_reference_entries(ref_fields, tmp_path):
    path = str(tmp_path / "profile.json")
    with open(path, "w") as f:
        json.dump(DRIFTING_PROFILE, f)
    updates = PORT.refresh_from_telemetry(path, N_DEV, torch.device("cpu"))
    with open(path) as f:
        got = json.load(f)
    assert got == ref_fields["refreshed"]
    assert updates and set(updates) < set(got)
    assert TP.current_cost_profile() == TP.CostProfile()


def test_zipf_overflow_at_each_capacity_factor_equals_reference(
        monkeypatch):
    monkeypatch.setattr(REF, "time_fn", lambda fn, **kw: 1.0)
    monkeypatch.setattr(PORT.DJB, "bench_runs",
                        lambda fn, *a, **kw: [1.0] * 5)
    rows, groups, cfs = 16384, 2048, [0.5, 1.0, 1.25, 1.5, 2.0, 3.0]
    want = REF.sweep_groups(rows, [groups], 3, None, cfs)["raw"]
    got = PORT.sweep_groups(rows, [groups], 3, None, cfs,
                            torch.device("cpu"))["raw"]
    assert got["overflow_at_cf"] == want["overflow_at_cf"]
    assert list(got["overflow_at_cf"].values())[0] > 0


# ---------------------------------------------------------------------------
# (c) the profile file, explain under a flipped profile, the plan cache
# ---------------------------------------------------------------------------
def test_written_profile_loads_to_equal_fields_in_both(tmp_path):
    path = str(tmp_path / "p.json")
    assert PORT.main(["--device", "cpu", "--rows", "4096", "--cols", "1",
                      "2", "4", "--sweep-groups", "--groups-sweep", "64",
                      "256", "--dist", "--dist-devices", "2", "--dist-probe",
                      "1024", "--dist-builds", "64", "256", "--exchange",
                      "--exchange-build", "256", "--exchange-probes", "512",
                      "2048", "--morsel", "--morsel-probes", "256", "1024",
                      "--out", path]) == 0
    got, want = TP.load_cost_profile(path), RP.load_cost_profile(path)
    fields = [f for f in TP.CostProfile.__dataclass_fields__ if f != "source"]
    assert set(fields) == {f for f in RP.CostProfile.__dataclass_fields__
                           if f != "source"}
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.source == "cpu" and got != TP.CostProfile()


FLIPPING_PROFILE = {"fused_fixed": 40.0, "fused_per_col": 4.0,
                    "sort_pass_factor": 0.05, "dense_group_limit": 8,
                    "backend": "cpu"}


@pytest.fixture(scope="module")
def tpch_data():
    ref = R.generate(scale=0.004, seed=1)
    return ref, T.from_numpy(ref.tables, ref.scale, device="cpu")


def test_flipped_profile_explains_alike_and_keys_the_plan_cache(tpch_data,
                                                                tmp_path):
    ref_data, port_data = tpch_data
    path = str(tmp_path / "flip.json")
    with open(path, "w") as f:
        json.dump(FLIPPING_PROFILE, f)
    ctx_t, ctx_r = TP.ExecutionContext(), RP.ExecutionContext()
    names = ("q1", "q3", "q18")

    def port_text(name):
        return [d.describe() for d in TP.explain(
            T.LOGICAL_QUERIES[name], port_data.tables, ctx_t)]

    builtin = {n: port_text(n) for n in names}
    TP.clear_plan_cache()
    plan = T.LOGICAL_QUERIES["q1"]
    first = TP.compile_plan(plan, port_data.tables, ctx_t)
    TP.load_cost_profile(path)
    RP.load_cost_profile(path)
    flipped = {n: port_text(n) for n in names}
    for n in names:
        want = [d.describe() for d in RP.explain(
            R.LOGICAL_QUERIES[n], ref_data.as_jax(), ctx_r)]
        assert flipped[n] == want, n
    assert any(flipped[n] != builtin[n] for n in names)
    second = TP.compile_plan(plan, port_data.tables, ctx_t)
    assert TP.plan_cache_size() == 2
    assert second.physical != first.physical
    TP.set_cost_profile(None)
    again = TP.compile_plan(plan, port_data.tables, ctx_t)
    assert TP.plan_cache_size() == 2 and again.physical == first.physical
