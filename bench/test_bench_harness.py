"""CPU tests of the benchmark harness (run: ``PYTHONPATH=src python -m pytest
bench/test_bench_harness.py -q``).  Runs go through ``harness.run_cell`` on the
CPU at tiny sizes, with the look for a card skipped; the test marked ``cuda``
decides inside itself whether a card is there."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import datasets, harness, traffic  # noqa: E402
from bench.catalog import Catalog, role_of  # noqa: E402
from bench.reference import knn as reference  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
TINY = {"ward-vbm": dict(n=4000, c_max=64), "tracking-vbm": dict(n=2000, c_max=45)}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the harness and BENCHMARK.json with every
    configuration cut to a few thousand rows and every mix to 128-query
    batches; nothing else of the cells changes."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg["dataset"]["n"] = TINY[c["name"]]["n"]
        cfg["index"]["c_max"] = TINY[c["name"]]["c_max"]
        path.write_text(json.dumps(cfg))
    for path in (tmp_path / "bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(batch=128, pool=3)
        path.write_text(json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def run(root, cell, *, seed=3_000_000_011, trace=False, wrap=None):
    return harness.run_cell(Path(root), cell, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu", wrap=wrap)


# -- finding the parts by name ------------------------------------------------

def test_every_cell_finds_its_parts_by_name():
    cat = Catalog(ROOT)
    for cell in cat.spec["workloads"]:
        cfg = cat.config(cell["config"])
        mix = cat.mix(cell["traffic"])
        traffic.check_mix(mix)
        assert cfg["dataset"]["generator"] in ("ward", "tracking")
        for trace in (False, True):
            names = [m["name"] for m in cat.metrics(cell["name"], trace)]
            assert names, (cell["name"], trace)
            for name in names:
                assert callable(cat.reader(name).read)
    roles = cat.roles()
    assert role_of("void (anonymous namespace)::scan_phase_kernel<float, false>(x)", roles) == "scan"
    assert role_of("void at::native::radixSortKVInPlace<2, -1, 128, 32, float, long>", roles) == "sort"
    assert role_of("void (anonymous namespace)::pairwise_small(float const*)", roles) == "bounds"
    assert role_of("Memcpy DtoH (Device -> Pageable)", roles) is None


def test_a_new_cell_config_mix_metric_and_role_are_files_of_their_own(tiny_root):
    before = {p: p.read_bytes() for p in (tiny_root / "bench").rglob("*") if p.is_file()}
    b = tiny_root / "bench"
    cfg = json.loads((b / "configs" / "ward-vbm.json").read_text())
    cfg["index"]["c_max"] = 48
    (b / "configs" / "ward-small.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "b16k-k10.json").read_text())
    mix["k"] = 5
    (b / "traffic" / "b128-k5.json").write_text(json.dumps(mix))
    (b / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return ctx.window.calls\n")
    (b / "layers" / "zz_more.json").write_text(json.dumps({"roles": {"copy": ["memcpy"]}}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="ward-small", source="s", file="bench/configs/ward-small.json",
                                reduced=[], why="w"))
    spec["workloads"].append(dict(name="ward-small.b128-k5", config="ward-small",
                                  traffic="b128-k5", chips=1, why="w"))
    spec["end_to_end"].append(dict(name="calls_in_window.small", unit="calls", better="higher",
                                   bound=0.1, source="host_clock",
                                   workloads=["ward-small.b128-k5"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data, p
    cat = Catalog(tiny_root)
    assert role_of("Memcpy HtoD", cat.roles()) == "copy"
    out = run(tiny_root, "ward-small.b128-k5")
    assert out["correct"]
    assert out["metrics"]["calls_in_window.small"]["value"] >= 1
    assert "queries_per_s.ward" not in out["metrics"]  # not listed for the new cell
    assert "setup_s" in out["metrics"]  # listed for every cell


# -- the frozen generators ----------------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(generator="ward", n=6000, dim=5, classes=13, geometry_seed=1, sample_seed=1),
    dict(generator="tracking", n=3000, dim=20, tracks=24, outlier_share=0.03, geometry_seed=0,
         sample_seed=0),
])
def test_the_geometry_is_fixed_and_the_sample_seed_draws_the_rows(spec):
    a = datasets.make(spec)
    b = datasets.make({**spec, "sample_seed": 987_654_321_012})
    geo_a = datasets.geometry(spec)
    geo_b = datasets.geometry({**spec, "sample_seed": 987_654_321_012})
    for u, v in zip(geo_a, geo_b):
        assert np.array_equal(np.asarray(u), np.asarray(v))
    assert a.shape == b.shape == (spec["n"], spec["dim"]) and a.dtype == np.float32
    assert not np.array_equal(a, b)
    assert np.array_equal(a, datasets.make(dict(spec)))


def test_the_geometry_is_the_ports_generators():
    """The replayed geometry is the one the port's generators draw: their
    rows sit around the same class centres with the same per-axis scales, and
    along the same track lines."""
    from repro_torch.data import synthetic

    geo = datasets.ward_geometry(20_000, 5, 13, 1)
    x = synthetic.ward_like(20_000, 5, seed=1)
    lo = 0
    for c, m, s in zip(geo.centers, geo.counts, geo.scales):
        part = x[lo:lo + m]
        lo += m
        assert np.allclose(part.mean(0), c, atol=4 * s.max() / np.sqrt(m) + 1e-3)
        assert np.allclose(part.std(0), s, rtol=0.25)
    geo = datasets.tracking_geometry(6000, 20, 24, 0.03, 0)
    x = synthetic.tracking_like(6000, 20, seed=0)
    lo = 0
    for start, heading, m in zip(geo.starts, geo.headings, geo.counts):
        part = x[lo:lo + m] - start
        lo += m
        along = part @ heading
        off = part - along[:, None] * heading
        # most rows lie within the sensor noise of the line; 3% are outliers
        assert np.median(np.linalg.norm(off, axis=1)) < 0.8 * np.sqrt(20) * 1.5


def test_the_run_seed_draws_the_queries():
    spec = dict(generator="ward", n=3000, dim=5, classes=13, geometry_seed=1, sample_seed=1)
    x = datasets.make(spec)
    mix = dict(kind="closed_loop_batches", batch=64, k=10, pool=2, check_calls=1)
    p1 = traffic.query_pool(x, mix, 2**31 + 5)
    assert [q.shape for q in p1] == [(64, 5)] * 2
    assert np.array_equal(p1[0], traffic.query_pool(x, mix, 2**31 + 5)[0])
    assert not np.array_equal(p1[0], traffic.query_pool(x, mix, 6)[0])
    assert not np.array_equal(p1[0], p1[1])


# -- the reference and the comparison -----------------------------------------

def test_the_reference_is_the_hand_computed_knn():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [3.0, 3.0], [-1.0, -1.0], [5.0, 0.0]])
    q = torch.tensor([[0.1, 0.0], [3.0, 2.5], [4.0, 0.0]])
    # squared distances, worked by hand:
    # q0: 0.01, 0.81, 4.01, 17.81, 2.21, 24.01 -> rows 0, 1, 4
    # q1: 15.25, 10.25, 9.25, 0.25, 28.25, 10.25 -> rows 3, 2, then 1 or 5 (a tie)
    # q2: 16, 9, 20, 10, 26, 1 -> rows 5, 1, 3
    truth = reference.exact_knn(x, q, 3)
    got = truth.ids.tolist()
    assert got[0] == [0, 1, 4] and got[2] == [5, 1, 3]
    assert got[1][:2] == [3, 2] and got[1][2] in (1, 5)
    assert np.allclose(truth.kth_d2.numpy(), [2.21, 10.25, 10.0])
    d = np.sqrt(np.array([[0.01, 0.81, 2.21], [0.25, 9.25, 10.25], [1.0, 9.0, 10.0]]))
    ids = np.array([[0, 1, 4], [3, 2, 1], [5, 1, 3]])
    lim = dict(kth_gap=1e-6, dist_err=1e-6, bad_rows=0)
    ok = reference.judge(x, q, d, ids, truth, lim)
    assert ok == dict(kth_gap=0.0, dist_err=pytest.approx(0.0, abs=1e-7), bad_rows=0.0,
                      wrong_queries=0)
    tie = ids.copy()
    tie[1, 2] = 5  # the other row at 10.25 is as near: not wrong
    assert reference.judge(x, q, d, tie, truth, lim)["wrong_queries"] == 0
    far = ids.copy()
    far[0, 2] = 5
    assert reference.judge(x, q, d, far, truth, lim)["kth_gap"] > 0.5
    dup = ids.copy()
    dup[2, 2] = 5
    assert reference.judge(x, q, d, dup, truth, lim)["bad_rows"] == 1.0


def test_the_control_fails_the_check():
    """The reference with its products in TF32, in the program's place, reads
    far above the limits on WARD-like rows (on a CPU the operands are rounded
    to TF32 as the tensor cores round them)."""
    cfg = json.loads((ROOT / "bench" / "configs" / "ward-vbm.json").read_text())
    x = torch.from_numpy(datasets.make({**cfg["dataset"], "n": 20_000}))
    q = torch.from_numpy(traffic.queries(x.numpy(), 256, np.random.default_rng(4)))
    truth = reference.exact_knn(x, q, 10)
    d, i = reference.lowp_knn(x, q, 10)
    got = reference.judge(x, q, d, i, truth, cfg["check"])
    assert got["kth_gap"] > cfg["check"]["kth_gap"] and got["dist_err"] > cfg["check"]["dist_err"]
    assert got["wrong_queries"] > 0


@pytest.mark.cuda
def test_the_control_fails_the_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 products run on its tensor cores")
    cfg = json.loads((ROOT / "bench" / "configs" / "ward-vbm.json").read_text())
    x = torch.from_numpy(datasets.make({**cfg["dataset"], "n": 200_000})).cuda()
    q = torch.from_numpy(traffic.queries(x.cpu().numpy(), 2048, np.random.default_rng(4))).cuda()
    truth = reference.exact_knn(x, q, 10)
    d, i = reference.lowp_knn(x, q, 10)
    got = reference.judge(x, q, d, i, truth, cfg["check"])
    assert got["kth_gap"] > cfg["check"]["kth_gap"] and got["dist_err"] > cfg["check"]["dist_err"]


# -- whole runs on the CPU ----------------------------------------------------

@pytest.mark.parametrize("cell,trace", [("ward-vbm.b16k-k10", False),
                                        ("tracking-vbm.b16k-k10", True),
                                        ("ward-vbm.b16k-k100", True)])
def test_a_run_is_correct_and_its_line_has_the_contract_keys(tiny_root, cell, trace):
    out = run(tiny_root, cell, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"kth_gap", "dist_err", "bad_rows"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    cat = Catalog(tiny_root)
    want = {m["name"] for m in cat.metrics(cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want  # host-clock metrics are always read
    else:
        # no device here: the readers of device time find nothing and are left out
        assert not any(n.startswith(("scan_roofline", "device_idle")) for n in out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def _stale(ix, search):
    first = []

    def wrapped(q):
        res = search(q)
        if not first:
            first.append(res)
        return first[0]
    return wrapped


def _half(ix, search):
    def wrapped(q):
        res = search(q)
        h = len(q) // 2
        res.dists[h:] = np.inf
        res.ids[h:] = -1
        return res
    return wrapped


def _altered(ix, search):
    def wrapped(q):
        res = search(q)
        res.ids[0, -1] = (res.ids[0, -1] + ix.n_total // 2) % ix.n_total
        return res
    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, fault):
    out = run(tiny_root, "ward-vbm.b16k-k10", wrap=fault)
    assert out["correct"] is False
    assert out["failed"] > 0


# -- process-level rules ------------------------------------------------------

def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = list((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path)
        assert not found & {"jax", "jaxlib", "flax", "repro"}, (path, found)
        if "reference" in path.relative_to(ROOT / "bench").parts:
            assert "repro_torch" not in found, path


def test_a_run_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", "ward-vbm.b16k-k10",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present here")
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ward-vbm.b16k-k10", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
