"""npz round trip of a whole ``OverlapIndex``: forest arrays, host tree
copies, streaming delta buffers, dataset, config, reports.

The format is the JAX package's (``repro/api/persist.py``,
``FORMAT_VERSION = 1``, the same key names), so a file that either package
writes loads in the other.  Everything a restart needs is in one
``np.savez`` file (``allow_pickle`` stays False: arrays and JSON strings
only), so a loaded index serves bitwise-identical searches without
rebuilding: the flattened forest arrays are restored exactly, the host
``FlatTree`` copies (which maintenance rebuilds and the structure rollup
need) are reassembled from concatenated node arrays and offsets, and
``bucket_members`` is derived from the flattened arrays (``_flatten_trees``
writes buckets per tree in order, so (bucket_index, bucket_ids,
bucket_mask) already encodes the ragged member lists).

Snapshots hold the logical, unpadded state and the ``layout`` section of
the config (kind, shards, axis and the routing knobs), so a sharded or
routed snapshot that either package writes loads in the other under the
same layout, or re-sharded (``OverlapIndex.load(path, layout=...)``).
Neither package restores the ``obs`` section (telemetry belongs to the
process that serves, not to the file).
"""
from __future__ import annotations

import json
from dataclasses import asdict
from typing import Any

import numpy as np
import torch

from repro_torch.api.config import (
    Config,
    IndexConfig,
    LayoutConfig,
    SearchConfig,
    StreamConfig,
)
from repro_torch.core.bccf import BuildCounters, FlatTree, TreeStructure
from repro_torch.core.forest import ForestArrays
from repro_torch.core.pipeline import BuildReport
from repro_torch.stream.ingest import DeltaBuffer

FORMAT_VERSION = 1

# bucket_x is absent: every row is an exact copy of a dataset row
# (_flatten_trees does bucket_x[i, :m] = x[members], zero padding), so it is
# rebuilt bitwise from x_all + bucket_ids/bucket_mask on load
_FOREST_ARRAYS = (
    "index_centers", "index_radii", "neighbors", "is_overlap_index",
    "bucket_ids", "bucket_mask", "bucket_pivot",
    "bucket_radius", "bucket_index",
)
_DELTA_ARRAYS = (
    "x", "ids", "count", "pivot", "radius", "sum_x",
    "main_count", "main_sum", "main_radius", "dropped",
)
# the JAX package's BuildReport fields (the port's phase_s is not among
# them: the JAX package's BuildReport(**fields) would refuse it)
_REPORT_FIELDS = (
    "n_objects", "n_clusters", "n_indexes", "n_overlap_indexes",
    "dbscan_distances", "overlap_distances", "tree_distances",
    "tree_comparisons", "wall_time_s", "detail",
)


def _to_py(obj: Any) -> Any:
    """JSON fallback for tensors and numpy scalars/arrays in report dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


def normalize_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(ix, path) -> str:
    """Serialize an ``OverlapIndex`` (duck-typed) to ``path`` (.npz)."""
    forest: ForestArrays = ix.forest
    payload: dict[str, Any] = {
        "format_version": np.int64(FORMAT_VERSION),
        "config_json": np.array(json.dumps(asdict(ix.cfg))),
        "x_all": np.asarray(ix.x_all, np.float32),
        "n_total": np.int64(ix.n_total),
        "capacity": np.int64(ix.capacity),
        "forest_c_max": np.int64(forest.c_max),
        "build_stats_json": np.array(json.dumps(forest.build_stats, default=_to_py)),
        "rebuild_log_json": np.array(json.dumps(ix.rebuild_log, default=_to_py)),
    }
    for name in _FOREST_ARRAYS:
        payload[f"forest_{name}"] = np.asarray(getattr(forest, name))

    # host tree copies: ragged per-tree node arrays -> concat + offsets
    trees = forest.trees
    offs = np.zeros(len(trees) + 1, np.int64)
    for i, t in enumerate(trees):
        offs[i + 1] = offs[i] + len(t.node_children)
    dim = forest.bucket_x.shape[2]
    payload["tree_node_offsets"] = offs
    payload["tree_node_pivots"] = (
        np.concatenate([t.node_pivots for t in trees])
        if trees else np.zeros((0, 2, dim), np.float32)
    )
    payload["tree_node_radii"] = (
        np.concatenate([t.node_radii for t in trees])
        if trees else np.zeros((0, 2), np.float32)
    )
    payload["tree_node_children"] = (
        np.concatenate([t.node_children for t in trees])
        if trees else np.zeros((0, 2), np.int32)
    )
    payload["tree_counters"] = np.array(
        [[t.counters.distances, t.counters.comparisons] for t in trees], np.int64,
    ).reshape(len(trees), 2)
    payload["tree_structure_json"] = np.array(json.dumps([
        dict(
            n_internal=t.structure.n_internal,
            n_leaves=t.structure.n_leaves,
            height=t.structure.height,
            bucket_sizes=list(t.structure.bucket_sizes),
            nodes_per_level={str(k): v for k, v in t.structure.nodes_per_level.items()},
        )
        for t in trees
    ], default=_to_py))

    rep: BuildReport = ix.build_report
    payload["build_report_json"] = np.array(json.dumps(
        {f: getattr(rep, f) for f in _REPORT_FIELDS}, default=_to_py,
    ))

    delta = ix.delta
    payload["has_delta"] = np.bool_(delta is not None)
    if delta is not None:
        for name in _DELTA_ARRAYS:
            payload[f"delta_{name}"] = getattr(delta, name).cpu().numpy()
        # the drift monitor's baseline was captured at a specific moment
        # (last swap / first ingest); recomputing it at load over the grown
        # dataset would shift object-based (OBM) trigger decisions
        payload["monitor_baseline"] = np.asarray(ix.monitor.rates_baseline)

    path = normalize_path(path)
    with open(path, "wb") as f:
        # compressed: the preallocated delta buffers are mostly zero padding
        np.savez_compressed(f, **payload)
    return path


def load_state(path, *, device) -> dict[str, Any]:
    """Read ``path`` back into the components ``OverlapIndex.load`` wires
    up: config, dataset, forest (with host trees), delta (on ``device``),
    the monitor baseline (host numpy, as ``OverlapMonitor`` keeps it) and
    the reports."""
    path = normalize_path(path)
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(
                f"{path} was written by a newer format (v{version}); this "
                f"build reads up to v{FORMAT_VERSION} — upgrade repro_torch"
            )
        cfg_d = json.loads(str(z["config_json"]))
        cfg = Config(
            index=IndexConfig(**cfg_d["index"]),
            search=SearchConfig(**cfg_d["search"]),
            stream=StreamConfig(**cfg_d["stream"]),
            # absent in pre-layout snapshots: the single layout
            layout=LayoutConfig.from_dict(cfg_d.get("layout")),
        )

        forest_arrays = {n: z[f"forest_{n}"] for n in _FOREST_ARRAYS}
        bucket_index = forest_arrays["bucket_index"]
        bucket_ids = forest_arrays["bucket_ids"]
        bucket_mask = forest_arrays["bucket_mask"]
        x_all = np.asarray(z["x_all"], np.float32)
        bucket_x = x_all[np.clip(bucket_ids, 0, None)]
        bucket_x[~bucket_mask] = 0.0
        forest_arrays["bucket_x"] = bucket_x

        offs = z["tree_node_offsets"]
        piv, rad, chd = z["tree_node_pivots"], z["tree_node_radii"], z["tree_node_children"]
        counters = z["tree_counters"]
        structures = json.loads(str(z["tree_structure_json"]))
        trees: list[FlatTree] = []
        for gi, s in enumerate(structures):
            lo, hi = int(offs[gi]), int(offs[gi + 1])
            members = [
                bucket_ids[b][bucket_mask[b]].astype(np.int64)
                for b in np.flatnonzero(bucket_index == gi)
            ]
            trees.append(FlatTree(
                node_pivots=piv[lo:hi],
                node_radii=rad[lo:hi],
                node_children=chd[lo:hi],
                bucket_members=members,
                structure=TreeStructure(
                    n_internal=s["n_internal"],
                    n_leaves=s["n_leaves"],
                    height=s["height"],
                    bucket_sizes=list(s["bucket_sizes"]),
                    nodes_per_level={int(k): v for k, v in s["nodes_per_level"].items()},
                ),
                counters=BuildCounters(
                    distances=int(counters[gi, 0]),
                    comparisons=int(counters[gi, 1]),
                ),
            ))

        forest = ForestArrays(
            c_max=int(z["forest_c_max"]),
            trees=trees,
            build_stats=json.loads(str(z["build_stats_json"])),
            **forest_arrays,
        )

        delta = None
        monitor_baseline = None
        if bool(z["has_delta"]):
            delta = DeltaBuffer(
                **{n: torch.from_numpy(z[f"delta_{n}"]).to(device) for n in _DELTA_ARRAYS}
            )
            monitor_baseline = z["monitor_baseline"]

        rep_d = json.loads(str(z["build_report_json"]))
        report = BuildReport(config=cfg.index, **rep_d)

        return dict(
            cfg=cfg,
            x_all=x_all,
            n_total=int(z["n_total"]),
            capacity=int(z["capacity"]),
            forest=forest,
            delta=delta,
            monitor_baseline=monitor_baseline,
            build_report=report,
            rebuild_log=json.loads(str(z["rebuild_log_json"])),
        )
