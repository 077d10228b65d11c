"""The port's LM for every architecture family: embedding (and the whisper
encoder or the vision stub) -> the planned layers -> the head, with
teacher-forced forward, prefill and decode entry points and the kNN-LM
retrieval hook at the head during decode (the JAX package's
``repro/models/model.py``).

    model = Model(cfg)                          # seeded random weights, on "cuda"
    logits, aux, _ = model.forward(tokens)      # aux: summed router losses
    logits, cache = model.prefill(tokens, max_len=256)
    logits = model.decode_step(nxt, cache, pos, datastore=ds)
    loss, metrics = model.loss({"tokens": toks, "targets": tgts})  # differentiable

Weights are held in ``cfg.param_dtype`` as the JAX package holds them
(norms, the router and the SSM/RWKV vectors in f32) and every parameter
trains.  The serving entry points run under ``no_grad`` and the layers
compute in ``cfg.compute_dtype`` from the parameters themselves when the
dtypes agree, else from copies cast at init or load (``cast_weights``) and
made again on first use after a parameter changed in place.
``loss`` casts inside the autograd graph instead, and with ``cfg.remat``
other than "none" recomputes each layer in the backward pass (one
non-reentrant checkpoint a layer): "full" saves nothing of it, "dots" the
outputs of its products with no batch dims (``aten.mm`` / ``aten.addmm``,
the JAX package's ``dots_with_no_batch_dims_saveable``) and recomputes the
rest, batched products too.  The head is an f32 product with TF32 off, as
in JAX.

The cache is a list with one flat dict per sub-layer, the batch on axis 0 of
every leaf: ``{"k", "v"}`` (B, max_len, KV, hd) for GQA, ``{"c_kv",
"k_rope"}`` (B, max_len, lora | rope) for MLA, ``{"conv", "ssm"}`` for
Mamba, ``{"tm_shift", "tm_wkv", "cm_shift"}`` for RWKV and ``{"k", "v",
"ck", "cv"}`` for whisper's decoder; attention leaves in the compute dtype,
the SSM/WKV states in f32.  ``decode_step`` updates it in place.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.context import current_mesh, is_dtensor, shard_map, spec_axes
from repro_torch.distributed.sharding import logical_constraint, logical_spec
from repro_torch.kernels.ref import no_tf32
from repro_torch.models.attention import DecodeStep
from repro_torch.models.layers import (
    CastWeights,
    dense_init_,
    dtype_of,
    embedding_init_,
    layer_norm,
    param,
    rms_norm,
    rope_tables,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.transformer import (
    Seq,
    Stage,
    cast_layer,
    encoder_stage,
    init_layer_,
    plan_stages,
    stage_layers,
)

Tensor = torch.Tensor
Cache = list[dict[str, Tensor]]


class Model(nn.Module):
    """An LM of configuration ``cfg`` (any family of the JAX package's zoo)
    on ``device`` (``cuda`` unless the caller names one; without CUDA an
    unnamed device raises).  ``seed`` draws the JAX package's init
    distributions from a ``torch.Generator`` (other numbers than
    ``jax.random``); ``seed=None`` leaves the weights unset for
    ``params_from_jax`` to fill."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0):
        super().__init__()
        self.stages: list[Stage] = plan_stages(cfg)
        dev = resolve_device(device)
        if dev.type == "cuda":
            no_tf32()
        self.cfg = cfg
        self.device = dev
        self.cdt = dtype_of(cfg.compute_dtype)
        d, v = cfg.d_model, cfg.padded_vocab
        pdt, f32 = dtype_of(cfg.param_dtype), torch.float32
        self.embed = param((v, d), pdt, dev)
        self.final_norm = param((d,), f32, dev)
        self.lm_head = None if cfg.tie_embeddings else param((d, v), pdt, dev)
        if cfg.family == "encdec":
            self.final_norm_bias = param((d,), f32, dev)
            self.frame_proj = param((d, d), pdt, dev)
            self.enc = stage_layers([encoder_stage(cfg)], cfg, dev)
            self.enc_norm = param((d,), f32, dev)
            self.enc_norm_bias = param((d,), f32, dev)
        if cfg.frontend == "vision_stub":
            self.patch_proj = param((d, d), pdt, dev)
        self.layers = stage_layers(self.stages, cfg, dev)
        # RoPE width: MLA rotates its rope slice; whisper and RWKV nothing
        self.rope_dim = (cfg.mla.rope_head_dim if cfg.mla is not None
                         else 0 if cfg.family in ("encdec", "ssm") else cfg.resolved_head_dim)
        for mod in self.modules():
            if isinstance(mod, CastWeights):
                mod.cdt = self.cdt
        if seed is not None:
            self.init_weights(seed)

    def _all_layers(self):
        return list(self.layers) + list(getattr(self, "enc", []))

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        embedding_init_(self.embed, g)
        if self.lm_head is not None:
            dense_init_(self.lm_head, g)
        for name in ("frame_proj", "patch_proj"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), g)
        for name in ("final_norm", "final_norm_bias", "enc_norm", "enc_norm_bias"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        for layer in self._all_layers():
            init_layer_(layer, g)
        self.cast_weights()

    def cast_weights(self) -> None:
        """(Re)make the compute-dtype weights of the layers."""
        for layer in self._all_layers():
            cast_layer(layer, self.cdt)

    # ------------------------------------------------------------- helpers
    def _embed_tokens(self, tokens: Tensor, pos0: Tensor | None = None) -> Tensor:
        tok = tokens.to(self.device).long()
        # one flat lookup: a vocab-sharded table's masked lookup takes a
        # 1-d index
        x = F.embedding(tok.reshape(-1), self.embed).reshape(*tok.shape, -1).to(self.cdt)
        if self.cfg.family == "encdec":
            # whisper: sinusoidal positions at each row's own offset, added
            # to the lookup's sum (a vocab-sharded table's partial sum is
            # reduced first; DTensor 2.11 cannot add a replicated tensor to
            # the masked partial on meta)
            x = logical_constraint(x, ("batch", "seq", "embed"))
            b, s = tokens.shape
            positions = torch.arange(s, device=self.device).expand(b, s)
            if pos0 is not None:  # (B,) decode positions
                positions = positions + pos0[:, None]
            x = x + sinusoidal_at(positions, self.cfg.d_model).to(self.cdt)
        return logical_constraint(x, ("batch", "seq", "embed"))

    def _frontend(self, x: Tensor, patches: Tensor | None) -> Tensor:
        """vision stub: precomputed patch embeddings replace the leading
        positions."""
        if self.cfg.frontend != "vision_stub" or patches is None:
            return x
        p = torch.as_tensor(patches).to(self.device, self.cdt) @ self.patch_proj.to(self.cdt)
        return torch.cat([p, x[:, p.shape[1]:]], 1)

    def _encode(self, frames: Tensor) -> Tensor:
        """audio stub: precomputed frame embeddings -> the encoder layers."""
        c = self.cfg
        x = torch.as_tensor(frames).to(self.device, self.cdt) @ self.frame_proj.to(self.cdt)
        x = x + sinusoidal_positions(x.shape[1], c.d_model, self.device)[None].to(self.cdt)
        x = self._run(self.enc, x, Seq(rope=(None, None)), self._zero_aux(), None)
        return layer_norm(x, self.enc_norm, self.enc_norm_bias, c.norm_eps)

    def _head(self, x: Tensor) -> Tensor:
        c = self.cfg
        if c.family == "encdec":
            x = layer_norm(x, self.final_norm, self.final_norm_bias, c.norm_eps)
        else:
            x = rms_norm(x, self.final_norm, c.norm_eps)
        x = x.float()
        mesh = current_mesh()
        tied = self.lm_head is None
        w = self.embed.float() if tied else self.lm_head.float()
        if mesh is not None and is_dtensor(x):
            logits = head_per_device(mesh, x, w, tied)
        else:
            logits = _head_island(tied, None, x, w)[0]
        return logical_constraint(logits, ("batch", "seq", "vocab"))

    def _zero_aux(self) -> dict[str, Tensor]:
        z = torch.zeros((), dtype=torch.float32, device=self.device)
        return {"router_aux": z, "router_z": z}

    def _rope(self, positions: Tensor):
        if not self.rope_dim:
            return None, None
        return rope_tables(positions, self.rope_dim, self.cfg.rope_theta)

    def _run(self, layers, x: Tensor, seq: Seq, aux: dict, caches: list | None) -> Tensor:
        """x through ``layers`` in order, their router losses added into
        ``aux`` and their caches appended to ``caches`` where given.  While
        autograd records and ``cfg.remat`` is not "none", each layer is one
        checkpoint that returns its router losses (a recompute in the
        backward pass adds nothing to ``aux`` twice)."""
        remat = torch.is_grad_enabled() and self.cfg.remat != "none"
        policy = {"context_fn": _dots_saved} if self.cfg.remat == "dots" else {}
        for layer in layers:
            x = logical_constraint(x, ("batch", "seq", "embed"))
            if remat:
                x, la, lz = checkpoint(_layer_with_losses, layer, x, seq, use_reentrant=False,
                                       preserve_rng_state=False, **policy)
                aux["router_aux"] = aux["router_aux"] + la
                aux["router_z"] = aux["router_z"] + lz
                continue
            x, cache = layer(x, seq, aux)
            if caches is not None:
                caches.append(cache)
        return x

    def _forward(self, tokens, frames, patches, collect_cache: bool):
        tokens = torch.as_tensor(tokens)
        b, s = tokens.shape
        x = self._frontend(self._embed_tokens(tokens), patches)
        enc = self._encode(frames) if self.cfg.family == "encdec" else None
        positions = torch.arange(s, device=self.device).expand(b, s)
        seq = Seq(rope=self._rope(positions), enc=enc)
        aux = self._zero_aux()
        caches = [] if collect_cache else None
        x = self._run(self.layers, x, seq, aux, caches)
        return self._head(x), aux, caches

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: Tensor, *, frames: Tensor | None = None,
                patches: Tensor | None = None, collect_cache: bool = False):
        """Teacher-forced forward over (B, S) tokens (``frames`` (B, S_enc, D)
        for whisper, ``patches`` (B, P, D) for the vision stub).  Returns
        (logits (B, S, V) f32, {"router_aux", "router_z"} summed over the
        layers (zero without MoE), per-layer caches or None)."""
        return self._forward(tokens, frames, patches, collect_cache)

    # ---------------------------------------------------------------- loss
    def loss(self, batch: dict) -> tuple[Tensor, dict]:
        """Mean next-token cross-entropy over the targets in [0,
        vocab_size), the logsumexp over the padded vocabulary, plus
        ``router_aux_coef`` x aux and ``router_z_coef`` x z where
        ``cfg.moe``: the JAX package's ``Model.loss``.  ``batch`` holds
        "tokens" and "targets" (B, S), and "frames" / "patches" where the
        family takes them (arrays or tensors, anywhere).  Returns (loss,
        {"ce", "tokens", "router_aux" (MoE)}), differentiable while autograd
        records."""
        c = self.cfg
        logits, aux, _ = self._forward(batch["tokens"], batch.get("frames"),
                                       batch.get("patches"), False)
        targets = torch.as_tensor(batch["targets"]).to(self.device, torch.int64)
        mask = (targets >= 0) & (targets < c.vocab_size)
        tsafe = targets.clamp(0, c.padded_vocab - 1)
        mesh = current_mesh()
        if mesh is not None and is_dtensor(logits) and any(p.is_shard() for p in logits.placements):
            nll = nll_per_device(mesh, logits, tsafe)
        else:
            nll = _nll(logits, tsafe)
        ce = nll * mask
        denom = mask.sum().clamp(min=1)
        loss = ce.sum() / denom
        metrics = {"ce": loss, "tokens": denom}
        if c.moe is not None:
            loss = loss + c.moe.router_aux_coef * aux["router_aux"]
            loss = loss + c.moe.router_z_coef * aux["router_z"]
            metrics["router_aux"] = aux["router_aux"]
        return loss, metrics

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: Tensor, *, frames: Tensor | None = None,
                patches: Tensor | None = None, max_len: int,
                cache: Cache | None = None) -> tuple[Tensor, Cache]:
        """Process (B, S) prompt tokens; return (logits (B, S, V), a cache of
        ``max_len`` positions holding the prompt's, zeros after it, and the
        final SSM/RWKV states), ready for ``decode_step`` at pos = S.  The
        prompt's entries are written into ``cache`` where given (an
        ``init_cache`` of zeros, or the dry-run's sharded one)."""
        tokens = torch.as_tensor(tokens)
        logits, _, got = self.forward(tokens, frames=frames, patches=patches,
                                      collect_cache=True)
        if cache is None:
            cache = self.init_cache(tokens.shape[0], max_len)
        for lane, new in zip(cache, got):
            for name, t in new.items():  # the JAX package's pad-to-template
                lane[name][tuple(slice(0, n) for n in t.shape)] = t
        return logits, cache

    # -------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        return [layer.init_cache(batch_size, max_len, self.cdt, self.device)
                for layer in self.layers]

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, cache: Cache, pos, *, datastore=None) -> Tensor:
        """One decode step of (B, 1) tokens at ``pos`` (a scalar, or a (B,)
        vector: every row at its own cache position).  Updates ``cache`` in
        place and returns the (B, V) logits.

        With a ``datastore`` and ``cfg.retrieval.enabled``, the output is the
        kNN-LM interpolation ``log(lam p_knn + (1 - lam) p_lm)``, the
        pre-head hidden state querying the datastore
        (``repro_torch.serve.retrieval.knn_interpolate``)."""
        tokens = torch.as_tensor(tokens)
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=self.device).to(torch.int64).reshape(-1).expand(b)
        max_len = next((lane[n].shape[1] for lane in cache for n in ("k", "c_kv") if n in lane), 1)
        step = DecodeStep(pos, max_len, self.rope_dim, self.cfg.rope_theta)
        x = self._embed_tokens(tokens, pos)
        for layer, lane in zip(self.layers, cache):
            x = layer.decode(x, lane, step)
        logits = self._head(x)[:, 0, :]
        if datastore is not None and self.cfg.retrieval.enabled:
            from repro_torch.serve.retrieval import knn_interpolate

            logits = knn_interpolate(logits, x[:, 0, :], datastore, self.cfg)
        return logits


# remat="dots": the products with no batch dims are saved
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saved():
    return create_selective_checkpoint_contexts(_dots_policy)


def _nll(logits: Tensor, targets: Tensor) -> Tensor:
    """-log softmax(logits)[target]: the logsumexp less the target's logit."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, targets[..., None])[..., 0]


def _nll_island(vocab, ix, logits: Tensor, targets: Tensor):
    """One device's share of ``_nll`` over its block of the vocabulary: the
    logsumexp's max and sum and the target's logit reduced over ``vocab``
    (the max without a gradient: the logsumexp's does not depend on it)."""
    v = logits.shape[-1]
    top = yield ("pmax", vocab, logits.detach().amax(-1, keepdim=True))
    total = yield ("psum", vocab, torch.exp(logits - top).sum(-1))
    local = targets - ix(vocab) * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0] * mine
    gold = yield ("psum", vocab, gold)
    return (torch.log(total) + top[..., 0] - gold,)


def nll_per_device(mesh, logits: Tensor, targets: Tensor) -> Tensor:
    """``_nll`` as each device's program of ``mesh`` on logits split over
    the vocabulary as the rules split them: GSPMD's partitioned loss, whose
    gradient is each device's block (DTensor's gather backward would make
    zeros of the whole logits on every device)."""
    out = logical_spec(tuple(logits.shape), ("batch", "seq", "vocab"), mesh)
    vocab = spec_axes(out[2])
    return shard_map(partial(_nll_island, vocab), mesh, [out, out[:2]], [(out[:2], ())])(
        logits, targets)[0]


def head_per_device(mesh, x: Tensor, w: Tensor, tied: bool) -> Tensor:
    """The logits as each device's program of ``mesh``: its rows over its
    block of the vocabulary, as GSPMD runs the vocab-sharded table (DTensor
    would gather it whole)."""
    vocab = w.shape[0] if tied else w.shape[1]
    out = logical_spec((*x.shape[:2], vocab), ("batch", "seq", "vocab"), mesh)
    ws = (out[2], None) if tied else (None, out[2])
    return shard_map(partial(_head_island, tied), mesh, [out[:2] + (None,), ws],
                     [(out, ())])(x, w)[0]


def _head_island(tied: bool, ix, x: Tensor, w: Tensor):
    """The logits of x over the embedding rows (tied) or the head's columns."""
    return (torch.einsum("bsd,vd->bsv", x, w) if tied else x @ w,)


def _layer_with_losses(layer: nn.Module, x: Tensor, seq: Seq):
    """One layer as a function of its input: (output, router aux, router z)
    from an aux dict of its own."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"router_aux": z, "router_z": z}
    x, _ = layer(x, seq, aux)
    return x, aux["router_aux"], aux["router_z"]


def num_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def param_bytes(model: Model) -> int:
    """Bytes the parameters hold (each stored once, in its own dtype)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())
