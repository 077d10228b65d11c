"""Token data pipeline of the port (the JAX package's
``repro/data/pipeline.py``): deterministic, shardable, restart-safe.

* host-sharded streams: each data-parallel host draws a disjoint slice,
  indexed by (step, host), so a restart at step k reproduces the exact batch
  sequence (a checkpoint stores only the step counter);
* packed LM batches (inputs and targets shifted by one);
* modality stubs (frames / patches) made per input spec.

``DataConfig`` and ``TokenPipeline`` are numpy, copied unchanged, so their
batches are bitwise the JAX package's.  ``BatchSpec`` is the port's
shape-only stand-in for ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0


class TokenPipeline:
    """Synthetic-corpus LM stream (Zipfian unigram mix + ngram structure) —
    self-contained stand-in for a tokenized corpus reader with identical
    interface (``batch_at(step)``)."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks**1.1)
        self._probs /= self._probs.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        b_local = cfg.global_batch // self.n_hosts
        g = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id])
        )
        toks = g.choice(cfg.vocab_size, size=(b_local, cfg.seq_len + 1), p=self._probs)
        # inject local ngram structure so the loss is learnable
        rep = g.integers(0, cfg.seq_len // 4, size=(b_local,))
        for i, r in enumerate(rep):
            toks[i, r + 1 : r + 4] = toks[i, r]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }


@dataclass(frozen=True)
class BatchSpec:
    """The shape and numpy dtype of one model input (no data)."""

    shape: tuple[int, ...]
    dtype: np.dtype


def make_batch_specs(model: ModelConfig, shape: ShapeConfig) -> dict[str, BatchSpec]:
    """``BatchSpec`` stand-ins for every model input of a (model, shape)
    cell — the dry-run contract (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = np.dtype(np.int32), np.dtype(np.float32)
    specs: dict[str, BatchSpec] = {}
    if shape.kind == "train":
        specs["tokens"] = BatchSpec((b, s), i32)
        specs["targets"] = BatchSpec((b, s), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = BatchSpec((b, s), i32)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = BatchSpec((b, 1), i32)
    if model.family == "encdec" and shape.kind != "decode":
        specs["frames"] = BatchSpec((b, model.encoder_seq, model.d_model), f32)
    if model.frontend == "vision_stub" and shape.kind != "decode":
        specs["patches"] = BatchSpec((b, model.num_stub_patches, model.d_model), f32)
    return specs


def materialize_batch(model: ModelConfig, shape: ShapeConfig, seed: int = 0) -> dict:
    """Small-scale concrete batch matching make_batch_specs (for examples)."""
    g = np.random.default_rng(seed)
    out = {}
    for k, spec in make_batch_specs(model, shape).items():
        if spec.dtype == np.int32:
            out[k] = g.integers(0, model.vocab_size, spec.shape).astype(np.int32)
        else:
            out[k] = (g.normal(size=spec.shape) * 0.1).astype(np.float32)
    return out
