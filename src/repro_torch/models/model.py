"""The port's LM: embedding -> dense GQA layers -> tied or untied head, with
teacher-forced forward, prefill and decode entry points and the kNN-LM
retrieval hook at the head during decode (the JAX package's
``repro/models/model.py`` for the dense families).

    model = Model(cfg)                          # seeded random weights, on "cuda"
    logits, cache = model.prefill(tokens, max_len=256)
    logits = model.decode_step(nxt, cache, pos, datastore=ds)

Parameters are f32 (``cfg.param_dtype``); the layers compute in
``cfg.compute_dtype`` from copies cast once at init or load
(``cast_weights``).  The head is an f32 product with TF32 off, as in JAX.

The KV cache is a list with one ``{"k", "v"}`` dict per layer, each
(B, max_len, KV, hd) in the compute dtype with the batch on axis 0: an
explicit layout, so a serving engine merges a slot's lane without guessing
axes.  ``decode_step`` writes the new position into it in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import no_tf32
from repro_torch.models.attention import DecodeStep
from repro_torch.models.layers import (
    dense_init_,
    dtype_of,
    embedding_init_,
    rms_norm,
    rope_tables,
)
from repro_torch.models.transformer import DenseLayer, Stage, plan_stages

Tensor = torch.Tensor
Cache = list[dict[str, Tensor]]


class Model(nn.Module):
    """A dense GQA decoder LM of configuration ``cfg`` on ``device``
    (``cuda`` unless the caller names one; without CUDA an unnamed device
    raises).  ``seed`` draws the JAX package's init distributions from a
    ``torch.Generator`` (other numbers than ``jax.random``); ``seed=None``
    leaves the weights unset for ``params_from_jax`` to fill."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0):
        super().__init__()
        self.stages: list[Stage] = plan_stages(cfg)
        dev = resolve_device(device)
        if dev.type == "cuda":
            no_tf32()
        self.cfg = cfg
        self.device = dev
        self.cdt = dtype_of(cfg.compute_dtype)
        f32 = dict(dtype=torch.float32, device=dev)
        self.embed = nn.Parameter(
            torch.empty((cfg.padded_vocab, cfg.d_model), **f32), requires_grad=False
        )
        self.final_norm = nn.Parameter(torch.zeros((cfg.d_model,), **f32), requires_grad=False)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.padded_vocab), **f32), requires_grad=False
            )
        self.layers = nn.ModuleList([DenseLayer(cfg, dev) for _ in range(cfg.num_layers)])
        if seed is not None:
            self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        embedding_init_(self.embed, g)
        self.final_norm.zero_()
        if self.lm_head is not None:
            dense_init_(self.lm_head, g)
        for layer in self.layers:
            layer.init_(g)
        self.cast_weights()

    def cast_weights(self) -> None:
        """(Re)make the compute-dtype copies of the layer weights; call after
        changing parameters in place."""
        for layer in self.layers:
            layer.cast(self.cdt)

    # ------------------------------------------------------------- helpers
    def _embed_tokens(self, tokens: Tensor) -> Tensor:
        return self.embed[tokens.to(self.device).long()].to(self.cdt)

    def _head(self, x: Tensor) -> Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps).float()
        if self.lm_head is None:
            return torch.einsum("bsd,vd->bsv", x, self.embed)
        return x @ self.lm_head

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: Tensor, *, collect_cache: bool = False):
        """Teacher-forced forward over (B, S) tokens.  Returns (logits
        (B, S, V) f32, per-layer (k, v) or None); the JAX package's
        ``forward`` also returns router losses, which dense layers lack."""
        tokens = torch.as_tensor(tokens)
        b, s = tokens.shape
        x = self._embed_tokens(tokens)
        positions = torch.arange(s, device=self.device).expand(b, s)
        rope = rope_tables(positions, self.cfg.resolved_head_dim, self.cfg.rope_theta)
        caches = []
        for layer in self.layers:
            x, kv = layer(x, rope)
            caches.append(kv)
        return self._head(x), (caches if collect_cache else None)

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: Tensor, *, max_len: int) -> tuple[Tensor, Cache]:
        """Process (B, S) prompt tokens; return (logits (B, S, V), a cache of
        ``max_len`` positions holding the prompt's K/V, zeros after it),
        ready for ``decode_step`` at pos = S."""
        tokens = torch.as_tensor(tokens)
        logits, kvs = self.forward(tokens, collect_cache=True)
        cache = self.init_cache(tokens.shape[0], max_len)
        s = tokens.shape[1]
        for lane, (k, v) in zip(cache, kvs):
            lane["k"][:, :s] = k
            lane["v"][:, :s] = v
        return logits, cache

    # -------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        c = self.cfg
        shape = (batch_size, max_len, c.num_kv_heads, c.resolved_head_dim)
        return [
            {"k": torch.zeros(shape, dtype=self.cdt, device=self.device),
             "v": torch.zeros(shape, dtype=self.cdt, device=self.device)}
            for _ in self.layers
        ]

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, cache: Cache, pos, *, datastore=None) -> Tensor:
        """One decode step of (B, 1) tokens at ``pos`` (a scalar, or a (B,)
        vector: every row at its own cache position).  Writes the step's K/V
        into ``cache`` in place and returns the (B, V) logits.

        With a ``datastore`` and ``cfg.retrieval.enabled``, the output is the
        kNN-LM interpolation ``log(lam p_knn + (1 - lam) p_lm)``, the
        pre-head hidden state querying the datastore
        (``repro_torch.serve.retrieval.knn_interpolate``)."""
        tokens = torch.as_tensor(tokens)
        pos = torch.as_tensor(pos, device=self.device).to(torch.int64).reshape(-1)
        step = DecodeStep(pos.expand(tokens.shape[0]), cache[0]["k"].shape[1],
                          self.cfg.resolved_head_dim, self.cfg.rope_theta)
        x = self._embed_tokens(tokens)
        for layer, lane in zip(self.layers, cache):
            x = layer.decode(x, lane, step)
        logits = self._head(x)[:, 0, :]
        if datastore is not None and self.cfg.retrieval.enabled:
            from repro_torch.serve.retrieval import knn_interpolate

            logits = knn_interpolate(logits, x[:, 0, :], datastore, self.cfg)
        return logits


def num_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())
