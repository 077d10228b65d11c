"""Fault-tolerant checkpointing of the port, in the JAX package's layout
(``repro/checkpoint/checkpointing.py``), so a checkpoint either package
writes restores in the other:

* one ``step_<N>/`` directory per checkpoint: the tree's leaves as .npy
  files named ``{i:05d}_{name[:128]}.npy`` in ``jax.tree_util`` order, the
  name the leaf's key path joined by "_", and ``manifest.json`` (step, and
  per file its shape, dtype and crc32);
* atomic publish: written to ``step_<N>.tmp`` and ``os.rename``d;
* ``restore_latest`` validates the checksums and falls back to the
  previous checkpoint on corruption;
* retention: the newest ``keep`` checkpoints.

Leaves may be tensors (anywhere), numpy arrays, scalars or the train
state's ``Leaf`` views.  A bf16 leaf is written as its raw 2-byte words
under the descr ``<V2``, the bytes ``np.save`` writes for an
``ml_dtypes.bfloat16`` array, with ``"dtype": "bfloat16"`` in the
manifest; restore reads it back by the manifest's dtype.  (The JAX
package's own restore hands such a leaf on as ``|V2`` bytes, which
``jnp.asarray`` refuses.)  Restored leaves are CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_path, tree_unflatten

PyTree = Any


def _host(leaf) -> np.ndarray | torch.Tensor:
    if hasattr(leaf, "value"):  # a train state's view of the parameters
        leaf = leaf.value()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return np.asarray(leaf)


def _flatten(tree: PyTree) -> list[tuple[str, Any]]:
    return [("_".join(str(k) for k in path) or "leaf", leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def _write(path: Path, arr) -> str:
    """Write one leaf as .npy; returns its manifest dtype."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        raw = arr.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return "bfloat16"
    arr = np.asarray(arr)
    np.save(path, arr)
    return str(arr.dtype)


def _read(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: PyTree, *, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "files": []}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        fname = f"{i:05d}_{name[:128]}.npy"
        arr = _host(leaf)
        dtype = _write(tmp / fname, arr)
        crc = zlib.crc32((tmp / fname).read_bytes())
        manifest["files"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": dtype, "crc32": crc})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _checkpoints(ckpt_dir: Path) -> list[Path]:
    return sorted(d for d in ckpt_dir.iterdir()
                  if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"))


def _retain(ckpt_dir: Path, keep: int) -> None:
    for d in _checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def _validate(d: Path) -> bool:
    try:
        manifest = json.loads((d / "manifest.json").read_text())
        return all(zlib.crc32((d / f["file"]).read_bytes()) == f["crc32"]
                   for f in manifest["files"])
    except (OSError, ValueError, KeyError, TypeError):
        return False


def restore_checkpoint(d: str | Path, template: PyTree) -> PyTree:
    """Load into the structure of ``template``: its leaves in order, each
    file's leaf name checked against the template's."""
    d = Path(d)
    manifest = json.loads((d / "manifest.json").read_text())
    names = [f"{i:05d}_{name[:128]}.npy" for i, (name, _) in enumerate(_flatten(template))]
    files = [f["file"] for f in manifest["files"]]
    if files != names:
        raise ValueError(f"{d}: the checkpoint's leaves {files[:3]}... do not match the "
                         f"template's {names[:3]}... ({len(files)} against {len(names)})")
    return tree_unflatten(template, [_read(d / f["file"], f["dtype"])
                                     for f in manifest["files"]])


def restore_latest(ckpt_dir: str | Path, template: PyTree) -> tuple[PyTree | None, int]:
    """Newest valid checkpoint (corrupted ones are skipped with a warning).
    Returns (tree | None, step)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None, -1
    for d in reversed(_checkpoints(ckpt_dir)):
        if _validate(d):
            return restore_checkpoint(d, template), int(d.name.split("_")[1])
        print(f"[ckpt] WARNING: {d} failed checksum validation, trying older")
    return None, -1
