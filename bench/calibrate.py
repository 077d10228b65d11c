"""The readings that the limits of ``correct`` are set from, at a cell's own
size, on the card:

* the program's: the configuration's index, built once, then for each seed
  the seed's query pool, a short window at the cell's load and the same
  check as a run's (``harness.check``) on the answers of the same number of
  calls, once the index is freed; with the deployment's facts (indexes,
  buckets) and the seed's distances and bound distances a query; where the
  configuration routes (Alg. 2), also the seconds the routing table took to
  derive and the share of checked queries whose routed set holds fewer than
  k rows;
* the control's: the plain reference in the program's place at the
  precision below the configuration's, TF32 products (``knn.lowp_knn``, or
  ``routed.lowp_routed_knn`` where the configuration routes), judged by the
  same check on the same number of batches.

    python3 bench/calibrate.py --config ward-vbm --traffic b16k-k10 b16k-k100 \\
        --seeds 1 2 3 --control-seeds 1 2 3 --seconds 3 [--out FILE]

One process builds the index once for all the seeds and mixes given.  Prints
one JSON line a (seed, mix, side) and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default=None, help="run here without a card (tests)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    rows = list(readings(ROOT, args.config, args.traffic, args.seeds, args.control_seeds,
                         args.seconds, device=args.device))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


def readings(root, config_name, mixes, seeds, control_seeds, seconds, *, device=None):
    import torch

    from bench import datasets, harness, traffic
    from bench.catalog import Catalog
    from bench.reference import knn as reference
    from bench.reference import routed

    cat = Catalog(root)
    config = cat.config(config_name)
    mixes = {name: cat.mix(name) for name in mixes}
    limits = harness.check_limits(config)
    dev = harness.pick_device(1, device)
    cuda = dev.type == "cuda"
    if harness.writes(config):
        yield from stream_readings(config_name, config, mixes, seeds, control_seeds, limits,
                                   dev)
        return
    forest = harness.routes(config)
    t0 = time.perf_counter()
    x = datasets.make(config["dataset"])
    if seeds:
        ix = harness.build_index(x, config, int(next(iter(mixes.values()))["k"]), dev)
        owner = harness.program_owner(ix) if forest else None
        rep = ix.build_report
        facts = dict(indexes=int(ix.forest.n_indexes), buckets=int(ix.forest.n_buckets),
                     clusters=int(rep.n_clusters), overlap_indexes=int(rep.n_overlap_indexes),
                     build_s=time.perf_counter() - t0)
    answers = []
    for seed in seeds:
        for name, mix in mixes.items():
            k = int(mix["k"])
            pool = traffic.query_pool(x, mix, seed)

            def search(q, k=k):
                return ix.search(q, k=k)

            for i in range(harness.WARM_CALLS):
                search(pool[i % len(pool)])
            q0, d0, b0 = harness.search_counters(ix)
            window, kept = harness.run_window(search, pool, seconds, int(mix["check_calls"]),
                                              datasets.sample_rng(seed, 3))
            q1, d1, b1 = harness.search_counters(ix)
            answers.append((seed, name, pool, kept, dict(
                distances_per_query=(d1 - d0) / max(1, q1 - q0),
                bound_distances_per_query=(b1 - b0) / max(1, q1 - q0), calls=window.calls,
                queries_per_s=window.queries / window.wall_s)))
    if seeds:
        del ix, search
        if cuda:
            torch.cuda.empty_cache()
    routing = None
    if forest and (seeds or control_seeds):
        t1 = time.perf_counter()
        routing = harness.derived_routing(x, config, dev)
        derive_s = time.perf_counter() - t1
    for seed, name, pool, kept, seen in answers:
        t1 = time.perf_counter()
        got = harness.check(x, pool, kept, int(mixes[name]["k"]), limits, dev, routing, owner)
        row = dict(side="program", config=config_name, traffic=name, seed=seed,
                   correct=got.correct, checked_queries=got.queries,
                   wrong_queries=got.wrong_queries, check_s=time.perf_counter() - t1,
                   **got.numbers, **facts, **seen)
        if routing is not None:
            row.update(derive_s=derive_s, small_set_share=small_set_share(
                routing, [pool[c % len(pool)] for c, _ in kept], int(mixes[name]["k"])))
        print(json.dumps(row), flush=True)
        yield row
    xt = torch.as_tensor(x, device=dev)
    for seed in control_seeds:
        for name, mix in mixes.items():
            k = int(mix["k"])
            pool = traffic.query_pool(x, mix, seed)
            out = []
            for q in pool[: int(mix["check_calls"])]:
                qt = torch.as_tensor(q, device=dev)
                if routing is not None:
                    d, i = routed.lowp_routed_knn(xt, qt, k, routing)
                    out.append(routed.judge(xt, qt, d, i, k, routing, limits))
                else:
                    d, i = reference.lowp_knn(xt, qt, k)
                    truth = reference.exact_knn(xt, qt, k)
                    out.append(reference.judge(xt, qt, d, i, truth, limits))
            wrong = sum(r.pop("wrong_queries") for r in out)
            nums = reference.combine(out)
            row = dict(side="control", config=config_name, traffic=name, seed=seed,
                       correct=all(nums[n] <= limits[n] for n in nums),
                       wrong_queries=wrong, **nums)
            print(json.dumps(row), flush=True)
            yield row


def stream_readings(config_name, config, mixes, seeds, control_seeds, limits, dev):
    """The control's readings of a streaming configuration."""
    import torch

    from bench import datasets, harness, traffic
    from bench.reference import knn as reference
    from bench.reference import stream as written

    if seeds:
        raise ValueError("a stream's program readings are bench/run.py's, one run a seed")
    x = datasets.make(config["dataset"])
    geo = datasets.geometry(config["dataset"])
    for seed in control_seeds:
        for name, mix in mixes.items():
            k = int(mix["k"])
            pool = traffic.query_pool(x, mix, seed)
            warm = traffic.stream(x, geo, mix, pool, seed, traffic.WARM, harness.WARM_CALLS,
                                  start=-harness.WARM_CALLS)
            calls = traffic.stream(x, geo, mix, pool, seed, traffic.WINDOW, int(mix["calls"]))
            writes = warm.writes + calls.writes
            out = []
            for j in sorted(harness.judged_calls(mix, seed)):
                n = harness.WARM_CALLS + j + 1
                xt = torch.as_tensor(written.rows_through(x, writes, n), device=dev)
                qt = torch.as_tensor(calls.queries[j], device=dev)
                d, i = reference.lowp_knn(xt, qt, k)
                out.append(reference.judge(xt, qt, d, i, reference.exact_knn(xt, qt, k), limits))
            wrong = sum(r.pop("wrong_queries") for r in out)
            nums = dict(reference.combine(out), lost_rows=0.0)
            row = dict(side="control", config=config_name, traffic=name, seed=seed,
                       correct=all(nums[n] <= limits[n] for n in limits), wrong_queries=wrong,
                       **nums)
            print(json.dumps(row), flush=True)
            yield row


def small_set_share(routing, batches, k: int) -> float:
    """The share of the queries whose routed set, through each nearest
    center they have, holds fewer than k rows (where the search fills its
    answers with rows of other indexes)."""
    import numpy as np
    import torch

    from bench.reference import routed

    rows = torch.bincount(routing.owner, minlength=len(routing.centers))
    small = total = 0
    for q in batches:
        pair_q, pair_c = routed.nearest(routing, torch.as_tensor(q))
        size = (routing.routed[pair_c].long() * rows[None, :]).sum(1).numpy()
        short = np.zeros(len(q), bool)
        np.logical_or.at(short, pair_q.numpy(), size < k)
        small, total = small + int(short.sum()), total + len(q)
    return small / max(1, total)


if __name__ == "__main__":
    sys.exit(main())
