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
from types import SimpleNamespace

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
from bench.reference import forest as forest_ref  # noqa: E402
from bench.reference import routed  # noqa: E402
from bench.reference import stream as written  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the delta capacity is cut with the rows: 48 rows in one index's delta
# bucket (its fill trigger) rebuild it within the few calls of a tiny stream
TINY = {"ward-vbm": dict(n=4000, c_max=64), "tracking-vbm": dict(n=2000, c_max=45),
        "tracking-vbm-forest": dict(n=2000, c_max=45),
        "ward-vbm-stream": dict(n=4000, c_max=64, capacity=64)}
TINY_STREAM = dict(ingest=64, recent=64, calls=6)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the harness and BENCHMARK.json with every
    configuration cut to a few thousand rows and every mix to 128-query
    batches (a stream to 6 calls of 64 rows written); nothing else of the
    cells changes."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg["dataset"]["n"] = TINY[c["name"]]["n"]
        cfg["index"]["c_max"] = TINY[c["name"]]["c_max"]
        if "stream" in cfg:
            cfg["stream"]["capacity"] = TINY[c["name"]]["capacity"]
        path.write_text(json.dumps(cfg))
    for path in (tmp_path / "bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(batch=128, pool=3)
        if traffic.streams(mix):
            mix.update(TINY_STREAM)
        path.write_text(json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


FOREST = "tracking-vbm-forest.b16k-k10"
STREAM = "ward-vbm-stream.b16k-w1k-k10"
SEED = 3_000_000_011


def run(root, cell, *, seed=SEED, trace=False, wrap=None, t_start=None, seconds=0.3):
    return harness.run_cell(Path(root), cell, seed, seconds, trace,
                            t_start=time.perf_counter() if t_start is None else t_start,
                            device="cpu", wrap=wrap)


# -- finding the parts by name ------------------------------------------------

def test_every_cell_finds_its_parts_by_name():
    cat = Catalog(ROOT)
    modes, kinds = set(), set()
    for cell in cat.spec["workloads"]:
        cfg = cat.config(cell["config"])
        mix = cat.mix(cell["traffic"])
        traffic.check_mix(mix)
        assert cfg["dataset"]["generator"] in ("ward", "tracking")
        modes.add(cfg["search"]["mode"])
        kinds.add(mix["kind"])
        assert "mode" not in mix and "check" not in mix  # both are the configuration's
        assert set(traffic.COUNTS[mix["kind"]]) <= set(mix)
        assert traffic.streams(mix) == harness.writes(cfg) == ("drift" in mix)
        limits = harness.check_limits(cfg)
        judge = harness.judge_of(cfg)
        assert judge is (written if "stream" in cfg else routed if harness.routes(cfg)
                         else reference)
        assert tuple(limits) == judge.NUMBERS
        assert cfg["reference"] == f"bench/reference/{judge.__name__.rsplit('.', 1)[1]}.py"
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
    assert modes == {"forest", "all"}
    assert kinds == set(traffic.KINDS)
    assert written.NUMBERS == reference.NUMBERS + ("lost_rows",)


@pytest.mark.parametrize("name,mode,drop,add", [
    ("tracking-vbm", "forest", [], []),  # a routed search judged by the exact search's limits
    ("tracking-vbm-forest", "all", [], []),
    ("tracking-vbm-forest", "forest", ["index_rows"], []),
    ("tracking-vbm-forest", "forest", [], ["kth_gap"]),
    ("ward-vbm-stream", "all", ["lost_rows"], []),  # a stream judged as a static search
    ("ward-vbm", "all", [], ["lost_rows"]),
])
def test_a_configuration_without_its_searchs_limits_is_refused(name, mode, drop, add):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    assert tuple(harness.check_limits(cfg)) == harness.judge_of(cfg).NUMBERS
    cfg["search"]["mode"] = mode
    cfg["check"] = {n: v for n, v in cfg["check"].items() if n not in drop}
    cfg["check"].update({n: 0.0 for n in add})
    with pytest.raises(ValueError, match="comparison"):
        harness.check_limits(cfg)


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


# -- the routed reference (forest mode) ---------------------------------------

# A forest of three indexes over eight rows in the plane: index 0 holds rows
# 0-2 in two buckets and links index 1 as its overlap neighbour; index 1
# holds rows 3-4, index 2 rows 5-7.
TINY_X = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [10.0, 0.0], [11.0, 0.0],
                       [0.0, 10.0], [1.0, 10.0], [0.0, 11.0]])
TINY_Q = torch.tensor([[2.0, 0.0], [0.2, 5.8], [10.2, 0.0], [0.0, 5.0]])
LIM = dict(routed_gap=2e-5, dist_err=2e-5, bad_rows=0, outside_rows=0)


TINY_BUCKETS = dict(bucket_ids=[[0, 1, -1], [2, -1, -1], [3, 4, -1], [5, 6, 7]],
                    bucket_index=[0, 0, 1, 2])


def _tiny_routing():
    owner = routed.owner_of_forest(**TINY_BUCKETS, n=8)
    return routed.Routing.of([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]], [[1], [-1], [-1]], owner)


def _answers(rows):
    """Sorted (dists, ids) host arrays of the given rows of each query."""
    ids = np.array(rows)
    d = np.sqrt(((TINY_X.numpy()[ids] - TINY_Q.numpy()[:, None, :]) ** 2).sum(-1))
    return d.astype(np.float32), ids.astype(np.int32)


def test_the_routed_reference_is_the_hand_computed_routed_knn():
    r = _tiny_routing()
    assert r.owner.tolist() == [0, 0, 0, 1, 1, 2, 2, 2]
    # squared distances to the centers, worked by hand:
    # q0 (2, 0):     4, 64, 104         -> index 0, routed rows 0-4 (with index 1)
    # q1 (0.2, 5.8): 33.68, 130.68, 17.68 -> index 2, rows 5-7
    # q2 (10.2, 0):  104.04, 0.04, 204.04 -> index 1, rows 3-4: fewer than k = 3
    # q3 (0, 5):     25, 125, 25          -> a tie: index 0 or index 2
    pair_q, pair_c = routed.nearest(r, TINY_Q)
    assert pair_q.tolist() == [0, 1, 2, 3, 3] and pair_c.tolist() == [0, 2, 1, 0, 2]
    truth = routed.routed_knn(TINY_X, TINY_Q[pair_q], 3, r, pair_c)
    # q0: rows 0-4 at 4, 1, 5, 64, 81           -> 1, 0, 2
    # q1: rows 5-7 at 17.68, 18.28, 27.08       -> 5, 6, 7 (row 2, at 23.08, is not routed)
    # q2: rows 3-4 at 0.04, 0.64                -> 3, 4, none
    # q3 via 0: rows 0-4 at 25, 26, 16, 125, 146 -> 2, 0, 1; via 2: 25, 26, 36 -> 5, 6, 7
    assert truth.ids.tolist() == [[1, 0, 2], [5, 6, 7], [3, 4, -1], [2, 0, 1], [5, 6, 7]]
    assert truth.size.tolist() == [5, 3, 2, 5, 3]
    assert np.allclose(truth.d2.numpy(), [[1, 4, 5], [17.68, 18.28, 27.08],
                                          [0.04, 0.64, np.inf], [16, 25, 26], [25, 26, 36]])
    # the routed answers pass; q2's third answer is a row of another index,
    # as the search fills a routed set smaller than k
    d, ids = _answers([[1, 0, 2], [5, 6, 7], [3, 4, 0], [2, 0, 1]])
    got = routed.judge(TINY_X, TINY_Q, d, ids, 3, r, LIM)
    assert got == dict(routed_gap=0.0, dist_err=pytest.approx(0.0, abs=1e-7), bad_rows=0.0,
                       outside_rows=0.0, wrong_queries=0)
    # a routed top-k row dropped: q0 answers 0, 2, 3 without row 1 (d2 1),
    # K = 64, so the gap is (64 - 1) / (4 + 1)
    d, ids = _answers([[0, 2, 3], [5, 6, 7], [3, 4, 0], [2, 0, 1]])
    got = routed.judge(TINY_X, TINY_Q, d, ids, 3, r, LIM)
    assert got["routed_gap"] == pytest.approx(12.6) and got["wrong_queries"] == 1
    # the exact answers over every row: q1's row 2 lies outside its routed set
    d, ids = _answers([[1, 0, 2], [5, 6, 2], [3, 4, 0], [2, 0, 1]])
    got = routed.judge(TINY_X, TINY_Q, d, ids, 3, r, LIM)
    assert got["outside_rows"] == 1.0 and got["routed_gap"] == 0.0 and got["wrong_queries"] == 1


def test_a_query_at_a_tied_center_passes_with_either_routing():
    r = _tiny_routing()
    for q3 in ([2, 0, 1], [5, 6, 7]):
        d, ids = _answers([[1, 0, 2], [5, 6, 7], [3, 4, 0], q3])
        assert routed.judge(TINY_X, TINY_Q, d, ids, 3, r, LIM)["wrong_queries"] == 0
    # rows of both routings in one answer fit neither
    d, ids = _answers([[1, 0, 2], [5, 6, 7], [3, 4, 0], [2, 5, 0]])
    got = routed.judge(TINY_X, TINY_Q, d, ids, 3, r, LIM)
    assert got["wrong_queries"] == 1 and got["outside_rows"] == 1.0


@pytest.mark.parametrize("bucket_ids,bucket_index,rows", [
    (TINY_BUCKETS["bucket_ids"], [0, 0, 1, 2], 0),
    (TINY_BUCKETS["bucket_ids"], [2, 2, 0, 1], 0),  # the same indexes, numbered otherwise
    ([[0, 1, -1], [2, -1, -1], [3, 4, -1], [5, 6, -1]], [0, 0, 1, 2], 1),  # row 7 in no bucket
    ([[0, 1, 1], [2, -1, -1], [3, 4, -1], [5, 6, 7]], [0, 0, 1, 2], 1),  # row 1 twice
    ([[0, 1, 7], [2, -1, -1], [3, 4, -1], [5, 6, -1]], [0, 0, 1, 2], 1),  # row 7 moved
    (TINY_BUCKETS["bucket_ids"], [0, 3, 1, 2], 1),  # index 0 split: row 2 apart
    (TINY_BUCKETS["bucket_ids"], [0, 0, 0, 2], 2),  # indexes 0 and 1 merged
    (TINY_BUCKETS["bucket_ids"], [0, 0, 0, 0], 5),  # one index for every row
])
def test_the_program_forest_is_held_to_the_derived_index_of_each_row(bucket_ids, bucket_index,
                                                                     rows):
    owner = routed.owner_of_forest(bucket_ids, bucket_index, 8)
    assert routed.index_rows(owner, _tiny_routing().owner.numpy()) == rows


def _blobs():
    """Five Gaussian blobs in 8-D and uniform noise: with eps 1.5, min_pts 8
    and xi 0.1 / 0.7 the VBM build makes overlap indexes, DBM merges and
    OBM makes one overlap index."""
    g = np.random.default_rng(7)
    centers = g.normal(size=(5, 8)) * 10.0
    parts = [c + g.normal(size=(400, 8)) for c in centers]
    parts.append(g.uniform(-15, 15, size=(100, 8)))
    return np.concatenate(parts).astype(np.float32)


def _cut(name, n, c_max):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    return datasets.make({**cfg["dataset"], "n": n}), {**cfg["index"], "c_max": c_max}


BLOB_INDEX = dict(eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7)


@pytest.mark.parametrize("case", ["blobs-vbm", "blobs-dbm", "blobs-obm", "tracking", "ward"])
def test_the_derived_routing_table_is_the_built_forests(case):
    """The plain derivation (DBSCAN, partitions, overlap rates, decision)
    gives each row the index the program's build gives it, numbered alike,
    with the same neighbour links and the centers to f32 rounding."""
    from repro_torch.core.pipeline import IndexConfig, build_index_core

    if case.startswith("blobs"):
        x, index = _blobs(), dict(BLOB_INDEX, method=case.split("-")[1])
    else:
        x, index = _cut(*{"tracking": ("tracking-vbm-forest", 2000, 45),
                          "ward": ("ward-vbm", 4000, 64)}[case])
    f, _ = build_index_core(x, IndexConfig(**index), device="cpu")
    r = forest_ref.derive(torch.from_numpy(x), index)
    owner = routed.owner_of_forest(f.bucket_ids, f.bucket_index, len(x))
    assert routed.index_rows(owner, r.owner.numpy()) == 0
    assert np.array_equal(owner, r.owner.numpy())
    links = np.zeros_like(r.routed.numpy())
    for i, row in enumerate(f.neighbors):
        links[i, row[row >= 0]] = True
    np.fill_diagonal(links, True)
    assert np.array_equal(links, r.routed.numpy())
    assert np.abs(f.index_centers - r.centers.numpy()).max() <= 1e-6 * np.abs(x).max()
    if case == "blobs-vbm":
        assert f.is_overlap_index.any() and links.sum() > len(links)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_the_routed_control_fails_the_check(device):
    """The routed reference with its products in TF32, in the program's
    place, reads far above the limits on Tracking-like rows routed by a
    hand-made forest of the tracks (on a CPU the operands are rounded to
    TF32 as the tensor cores round them)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 products run on its tensor cores")
    cfg = json.loads((ROOT / "bench" / "configs" / "tracking-vbm.json").read_text())
    spec = {**cfg["dataset"], "n": 12_000}
    x = torch.from_numpy(datasets.make(spec))
    counts = datasets.geometry(spec).counts
    owner = np.repeat(np.arange(len(counts)), counts)
    centers = np.stack([x.numpy()[owner == i].mean(0) for i in range(len(counts))])
    cap = int(counts.max())
    bucket_ids = np.full((len(counts), cap), -1)
    for i in range(len(counts)):
        rows = np.nonzero(owner == i)[0]
        bucket_ids[i, :len(rows)] = rows
    r = routed.Routing.of(centers, np.full((len(counts), 1), -1),
                          routed.owner_of_forest(bucket_ids, np.arange(len(counts)), len(x)))
    q = torch.from_numpy(traffic.queries(x.numpy(), 256, np.random.default_rng(4)))
    x, q = x.to(device), q.to(device)
    d, i = routed.lowp_routed_knn(x, q, 10, r)
    lim = harness.check_limits(json.loads(
        (ROOT / "bench" / "configs" / "tracking-vbm-forest.json").read_text()))
    got = routed.judge(x, q, d, i, 10, r, lim)
    assert got["dist_err"] > lim["dist_err"] and got["wrong_queries"] > 0


# -- whole runs on the CPU ----------------------------------------------------

@pytest.mark.parametrize("cell,trace", [("ward-vbm.b16k-k10", False),
                                        ("tracking-vbm.b16k-k10", True),
                                        ("ward-vbm.b16k-k100", True),
                                        (FOREST, True),
                                        (STREAM, False),
                                        (STREAM, True)])
def test_a_run_is_correct_and_its_line_has_the_contract_keys(tiny_root, cell, trace):
    out = run(tiny_root, cell, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    cat = Catalog(tiny_root)
    judge = harness.judge_of(cat.config(cat.cell(cell)["config"]))
    assert tuple(out["checks"]) == judge.NUMBERS
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    want = {m["name"] for m in cat.metrics(cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want  # host-clock metrics are always read
    else:
        # no device here: the readers of device time find nothing and are left out
        assert not any(n.startswith(("scan_roofline", "device_idle")) for n in out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        if cell == STREAM:  # the write path's readers read the program's own spans
            for name in ("ingest_ms", "rebuild_ms", "rebuilds_per_kcall"):
                assert out["metrics"][f"{name}.ward_stream"]["value"] > 0
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


def test_the_window_sends_the_whole_pool_at_least_once():
    calls = []
    window, kept = harness.run_window(calls.append, [np.zeros((2, 1))] * 5, 0.0, 2,
                                      np.random.default_rng(0))
    assert window.calls == len(calls) == 5 and len(kept) == 2


def _program_routing(ix):
    """The routing table of the program's own forest (to plant faults with)."""
    f = ix.forest
    return routed.Routing.of(f.index_centers, f.neighbors,
                             routed.owner_of_forest(f.bucket_ids, f.bucket_index, ix.n_total))


def _routed_answers(ix, q, rows_of):
    """A search result whose answers are the reference's routed k nearest
    of the index that ``rows_of(centers d2)`` picks for each query."""
    x = torch.from_numpy(np.asarray(ix.x_all))
    r = _program_routing(ix)
    qt = torch.from_numpy(q)
    d2c = ((qt.double()[:, None, :] - r.centers.double()[None]) ** 2).sum(-1)
    truth = routed.routed_knn(x, qt, ix.cfg.search.k, r, rows_of(d2c))
    return SimpleNamespace(dists=np.sqrt(truth.d2.numpy()).astype(np.float32),
                           ids=truth.ids.numpy().astype(np.int32))


def _drop_routed(ix, search):
    def wrapped(q):
        more = ix.search(q, k=ix.cfg.search.k + 1)
        return SimpleNamespace(dists=more.dists[:, 1:], ids=more.ids[:, 1:])
    return wrapped


def _second_index(ix, search):
    def wrapped(q):
        search(q)
        return _routed_answers(ix, q, lambda d2c: torch.argsort(d2c, 1)[:, 1])
    return wrapped


def _global_answers(ix, search):
    def wrapped(q):
        search(q)
        x, qt = torch.from_numpy(np.asarray(ix.x_all)), torch.from_numpy(q)
        truth = reference.exact_knn(x, qt, ix.cfg.search.k)
        return SimpleNamespace(dists=np.sqrt(reference.exact_d2(x, qt, truth.ids).numpy()),
                               ids=truth.ids.numpy().astype(np.int32))
    return wrapped


def _tf32_control(ix, search):
    def wrapped(q):
        search(q)
        d, i = routed.lowp_routed_knn(torch.from_numpy(np.asarray(ix.x_all)),
                                      torch.from_numpy(q), ix.cfg.search.k,
                                      _program_routing(ix))
        return SimpleNamespace(dists=d, ids=i)
    return wrapped


@pytest.mark.parametrize("fault,number", [
    (_drop_routed, "routed_gap"), (_second_index, "outside_rows"),
    (_global_answers, "outside_rows"), (_tf32_control, "dist_err"),
    (_stale, "routed_gap"), (_half, "bad_rows"), (_altered, "dist_err"),
], ids=["routed_row_dropped", "second_nearest_index", "global_answers", "tf32_control",
        "state_unchanged", "half_the_batch", "answer_altered"])
def test_a_planted_fault_makes_a_forest_run_incorrect(tiny_root, fault, number):
    out = run(tiny_root, FOREST, wrap=fault)
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_a_forest_built_wrong_makes_a_forest_run_incorrect(tiny_root, monkeypatch):
    """The program's forest with the buckets of its second index given to
    its first once the window is over: the answers were the program's own,
    but the index of each row is no longer the derived table's."""
    seen = []
    run_window = harness.run_window

    def then_merge(*args, **kw):
        out = run_window(*args, **kw)
        f = seen[0].forest
        f.bucket_index = np.where(f.bucket_index == 1, 0, f.bucket_index).astype(np.int32)
        return out
    monkeypatch.setattr(harness, "run_window", then_merge)
    out = run(tiny_root, FOREST, wrap=lambda ix, search: seen.append(ix) or search)
    f = seen[0].forest
    merged = int((np.asarray(f.bucket_ids)[np.asarray(f.bucket_index) == 0] >= 0).sum())
    assert out["correct"] is False
    assert out["checks"]["index_rows"]["limit"] < out["checks"]["index_rows"]["value"] < merged


def test_the_forest_run_routes_and_counts_its_bounds(tiny_root):
    """The forest cell searches with routing: each query bounds fewer
    buckets than the forest holds (``mode="all"`` bounds every one) and
    scans fewer rows than the same rows' exact cell."""
    seen = []

    def keep(ix, search):
        seen.append(ix)
        return search
    forest = run(tiny_root, FOREST, trace=True, wrap=keep)["metrics"]
    exact = run(tiny_root, "tracking-vbm.b16k-k10", trace=True)["metrics"]
    buckets = seen[0].forest.n_buckets
    assert 0 < forest["bound_distances_per_query.tracking_forest"]["value"] < buckets
    assert (forest["distances_per_query.tracking_forest"]["value"]
            < exact["distances_per_query.tracking"]["value"])


# -- a stream of writes and searches -------------------------------------------

def _stream(root):
    cat = Catalog(root)
    cfg = cat.config(cat.cell(STREAM)["config"])
    x = datasets.make(cfg["dataset"])
    return cat, cfg, x, datasets.geometry(cfg["dataset"]), cat.mix(cat.cell(STREAM)["traffic"])


def test_the_stream_is_drawn_from_the_seed(tiny_root):
    """The same seed gives the same writes and queries, another seed others;
    every seed writes the same number of rows into each class."""
    _, _, x, geo, mix = _stream(tiny_root)

    def draw(seed):
        pool = traffic.query_pool(x, mix, seed)
        return traffic.stream(x, geo, mix, pool, seed, traffic.WINDOW, int(mix["calls"]))
    a, b, c = draw(SEED), draw(SEED), draw(2**31 + 9)
    assert len(a.writes) == len(a.queries) == mix["calls"]
    assert [w.shape for w in a.writes] == [(mix["ingest"], 5)] * mix["calls"]
    assert [q.shape for q in a.queries] == [(mix["batch"], 5)] * mix["calls"]
    for u, v in zip(a.writes + a.queries, b.writes + b.queries):
        assert np.array_equal(u, v)
    assert not any(np.array_equal(u, v) for u, v in zip(a.writes, c.writes))
    assert not np.array_equal(a.queries[0], c.queries[0])
    # the last `recent` queries of a call lie around the rows it writes
    q = a.queries[0][-mix["recent"]:]
    d = ((q[:, None] - a.writes[0][None]) ** 2).sum(-1).min(1)
    assert np.sqrt(d).max() < 0.3 * x.std() * np.sqrt(5)
    # the classes' shares are fixed by the geometry, not the seed
    for s in (a, c):
        near = ((s.writes[0][:, None] - geo.centers[None]) ** 2).sum(-1).argmin(1)
        counts = np.bincount(near, minlength=len(geo.centers))
        assert np.abs(counts - datasets._apportion(mix["ingest"], geo.counts)).sum() <= 4


def test_the_stream_is_fixed_work(tiny_root):
    """Two runs on one seed write, search and rebuild alike, and the window
    is the whole stream whatever ``--seconds`` asks."""
    seen = []

    def keep(ix, search):
        seen.append(ix)
        return search
    short = run(tiny_root, STREAM, wrap=keep)
    long = run(tiny_root, STREAM, wrap=keep, seconds=5.0)
    assert short["correct"] and long["correct"]
    assert short["attempted"] == long["attempted"] == TINY_STREAM["calls"] * 128
    a, b = seen
    assert a.n_total == b.n_total == TINY["ward-vbm-stream"]["n"] + (
        harness.WARM_CALLS + TINY_STREAM["calls"]) * TINY_STREAM["ingest"]
    assert len(a.rebuild_log) == len(b.rebuild_log) >= 1
    assert [r["triggers"] for r in a.rebuild_log] == [r["triggers"] for r in b.rebuild_log]
    assert short["checks"] == long["checks"]


def test_a_drifting_stream_fires_the_overlap_trigger(tiny_root):
    """With ``drift`` > 0 the corridor between two classes widens until the
    monitor's overlap rate fires a rebuild; the cell's own mix (drift 0)
    rebuilds for fill alone.  Ten calls, for the corridor to widen."""
    path = tiny_root / "bench" / "traffic" / "b16k-w1k-k10.json"
    reasons = {}
    for drift in (0.0, 0.3):
        mix = json.loads(path.read_text())
        mix.update(drift=drift, calls=10)
        path.write_text(json.dumps(mix))
        seen = []
        out = run(tiny_root, STREAM, wrap=lambda ix, search: seen.append(ix) or search)
        assert out["correct"]
        reasons[drift] = {why for r in seen[0].rebuild_log
                          for whys in r["reasons"].values() for why in whys}
    assert "overlap" not in reasons[0.0] and "fill" in reasons[0.0]
    assert "overlap" in reasons[0.3]


def _judged_batch(root):
    """The batch count of the first judged call (warm-up writes included)."""
    _, _, _, _, mix = _stream(root)
    return harness.WARM_CALLS + min(harness.judged_calls(mix, SEED))


def _unwritten(target):
    def fault(ix, search):
        real, calls = ix.ingest, []

        def ingest(xb):
            calls.append(1)
            if len(calls) - 1 != target:
                return real(xb)
            # acknowledged under the next ids, but never put in a delta bucket
            ids = np.arange(ix.n_total, ix.n_total + len(xb))
            ix._x_parts.append(np.asarray(xb, np.float32))
            ix.n_total += len(xb)
            ix._x_cache = None
            return ids
        ix.ingest = ingest
        return search
    return fault


def _skip_delta(ix, search):
    def wrapped(q):
        delta, ix._delta = ix._delta, None
        try:
            return search(q)
        finally:
            ix._delta = delta
    return wrapped


def _drop_migrated(ix, search):
    from repro_torch.stream.ingest import alloc_delta

    real = ix._rebuild_impl

    def rebuild(triggers, report):
        real(triggers, report)
        # the indexes not rebuilt lose the rows their delta buckets held
        ix._delta = ix.backend.place_delta(
            alloc_delta(ix.forest, ix.capacity, device=ix.backend.device))
    ix._rebuild_impl = rebuild
    return search


def _previous_answer(ix, search):
    last = []

    def wrapped(q):
        res = search(q)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return wrapped


def _shifted_ids(ix, search):
    def wrapped(q):
        res = search(q)
        res.ids[res.ids >= 0] += 1
        return res
    return wrapped


def _stream_control(ix, search):
    """The reference in the program's place, its products in TF32, over
    every row written so far."""
    def wrapped(q):
        search(q)
        d, i = reference.lowp_knn(torch.from_numpy(np.asarray(ix.x_all)), torch.from_numpy(q),
                                  ix.cfg.search.k)
        return SimpleNamespace(dists=d, ids=i)
    return wrapped


@pytest.mark.parametrize("fault,numbers", [
    ("unwritten", ("kth_gap", "lost_rows")), (_skip_delta, ("kth_gap",)),
    (_drop_migrated, ("lost_rows",)), (_previous_answer, ("kth_gap", "dist_err")),
    (_shifted_ids, ("bad_rows",)), (_stream_control, ("dist_err",)),
], ids=["acknowledged_never_written", "search_skips_the_delta", "rebuild_drops_migrated_rows",
        "previous_calls_answer", "ids_shifted_by_one", "tf32_control"])
def test_a_planted_fault_makes_a_stream_run_incorrect(tiny_root, fault, numbers):
    if fault == "unwritten":
        fault = _unwritten(_judged_batch(tiny_root) - 1)
    out = run(tiny_root, STREAM, wrap=fault)
    assert out["correct"] is False
    for number in numbers:
        assert out["checks"][number]["value"] > out["checks"][number]["limit"], number


def test_lost_rows_counts_rows_held_other_than_once():
    bucket_ids = np.array([[0, 1, -1], [2, 2, -1]])  # row 2 twice
    delta_ids = np.array([[5, 7, -1], [4, -1, -1]])  # row 7 past the acknowledged 6
    held = written.held(bucket_ids, delta_ids, np.array([2, 1]))
    assert sorted(held.tolist()) == [0, 1, 2, 2, 4, 5, 7]
    # row 2 twice, row 3 never, id 7 names no row
    assert written.lost_rows(held, 6) == 3
    batches = [np.zeros((2, 1)), np.zeros((3, 1))]
    assert written.misnumbered([np.array([4, 5]), np.array([6, 7, 8])], batches, 4) == 0
    assert written.misnumbered([np.array([5, 6]), np.array([6, 7, 8])], batches, 4) == 2
    assert written.misnumbered([np.array([4, 5]), np.array([6, 7])], batches, 4) == 3


def test_a_cell_whose_mix_and_configuration_disagree_on_writes_is_refused(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"] += [dict(name="ward-vbm.w", config="ward-vbm", traffic="b16k-w1k-k10",
                               chips=1, why="w"),
                          dict(name="ward-vbm-stream.r", config="ward-vbm-stream",
                               traffic="b16k-k10", chips=1, why="w")]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell in ("ward-vbm.w", "ward-vbm-stream.r"):
        with pytest.raises(ValueError, match="stream entry"):
            run(tiny_root, cell)


# The check numbers and metrics of the accepted cells on a fixed seed and a
# clock that ticks 1/16 s a reading, as the harness before the stream read
# them (tiny_root, seed 3,000,000,011): the three mode="all" cells as the
# harness before the routed check read them, the forest cell as the harness
# that added it did.  Per-layer: the program's counters over the window.
BEFORE = {
    "ward-vbm.b16k-k10": (dict(kth_gap=0.0, dist_err=3.543533227533887e-07, bad_rows=0.0),
                          dict(distances_per_query=332.1171875)),
    "tracking-vbm.b16k-k10": (dict(kth_gap=1.721668999963367e-07,
                                   dist_err=2.581578834341598e-07, bad_rows=0.0),
                              dict(distances_per_query=105.21354166666667)),
    "ward-vbm.b16k-k100": (dict(kth_gap=2.7365993460619834e-09,
                                dist_err=3.543533227533887e-07, bad_rows=0.0),
                           dict(distances_per_query=393.6927083333333)),
    FOREST: (dict(routed_gap=0.0, dist_err=2.516553435257481e-07, bad_rows=0.0,
                  outside_rows=0.0, index_rows=0.0),
             dict(distances_per_query=51.466145833333336,
                  bound_distances_per_query=43.036458333333336)),
}


@pytest.mark.parametrize("cell", sorted(BEFORE))
@pytest.mark.parametrize("trace", [False, True])
def test_the_exact_cells_read_what_they_read_before(tiny_root, monkeypatch, cell, trace):
    clock = SimpleNamespace(t=0.0)

    def tick():
        clock.t += 0.0625
        return clock.t
    monkeypatch.setattr(harness, "time", SimpleNamespace(perf_counter=tick))
    out = run(tiny_root, cell, trace=trace, t_start=tick())
    checks, counted = BEFORE[cell]
    assert {n: c["value"] for n, c in out["checks"].items()} == checks
    assert out["attempted"] == 3 * 128
    got = {n.split(".")[0]: m["value"] for n, m in out["metrics"].items()}
    if trace:
        assert {n: got[n] for n in counted} == counted
    else:
        # 3 calls of two readings each: 384 queries in 0.375 s, each call 62.5 ms
        assert got == dict(queries_per_s=1024.0, search_p95_ms=62.5, setup_s=0.25)


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
