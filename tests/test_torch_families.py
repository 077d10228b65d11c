"""The port's model families (MoE, MLA, Mamba, RWKV, encoder-decoder, the
vision stub) against the JAX package's, with the JAX weights carried across
by ``params_from_jax``, on the eight architectures the dense slice lacked
at their ``SMOKE_CONFIG``.

Inputs are made with numpy and handed to both.  Tolerances:

* ``compute_dtype="float32"``: the two frameworks run the same f32
  arithmetic in other summation orders; logits, router losses, caches and
  states agree to ``atol = rtol = 1e-5`` (as ``tests/test_torch_models.py``),
  and greedy decoding picks the same tokens.
* bf16 compute: both round activations to bf16 at the same places, but
  their bf16 products differ in the last bit, which compounds over layers.
  These configurations have untied heads whose logits reach ~4 (the dense
  slice's tied heads stay below 1), and the JAX package's own bf16 logits
  lie up to 0.05-0.6 from its f32 logits on them, so
  ``tests/test_torch_models.py``'s ``atol = 3e-2`` is below the format's own
  noise here.  Where a near-tie in an MoE router flips one token's expert,
  that token's logits move by up to ~0.7, in either package at another
  token.  The bf16 gate is the noise band (``_close_bf16``): the port's
  bf16 logits lie no further (root mean square) from the JAX package's f32
  logits than 1.5 times the JAX package's bf16 logits do, plus 1e-2; one
  wrong position alone would stand ~4x past it.  Router losses to
  ``rtol = 3e-2``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import RetrievalConfig as JRetrievalConfig
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models.model import Model as JModel
from repro.serve import retrieval as jret
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig, MoEConfig, RetrievalConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import MLA, DecodeStep
from repro_torch.models.convert import _load, params_from_jax
from repro_torch.models.layers import rope_tables
from repro_torch.models.mamba import Mamba
from repro_torch.models.model import Model
from repro_torch.models.rwkv import ChannelMix, TimeMix
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.retrieval import build_flat_datastore

TIGHT = 1e-5
ARCHS = ["whisper-tiny", "pixtral-12b", "jamba-1.5-large-398b", "granite-20b",
         "deepseek-67b", "rwkv6-3b", "deepseek-v2-236b", "qwen3-moe-235b-a22b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    if isinstance(a, torch.Tensor):  # a module called outside no_grad records its graph
        a = a.detach()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TIGHT):
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol, atol=tol)


def _close_f32(got, want):
    """f32 logits: ``rtol = 1e-5`` and ``atol = 1e-5`` of their scale
    (max |want|, at least 1): reassociation noise is relative to the
    activations, and these reach ~16 (deepseek-v2's MLA) where the dense
    slice's stay below 1."""
    want = _np(want)
    atol = TIGHT * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got.float()), want, rtol=TIGHT, atol=atol)


def _rms(a, b):
    return float(np.sqrt(np.mean((_np(a) - _np(b)) ** 2)))


def _close_bf16(got, want16, want32):
    """The noise band of the module docstring."""
    err, band = _rms(got.float(), want32), 1.5 * _rms(want16, want32) + 1e-2
    assert err <= band, f"port bf16 is {err:.4f} (rms) from the f32 logits, band {band:.4f}"


def _inputs(cfg, b, s, seed):
    """(tokens, the JAX batch, the port's keyword inputs): frames for
    whisper, stub patches for pixtral."""
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if cfg.family == "encdec":
        fr = (g.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
        batch["frames"], kw["frames"] = jnp.asarray(fr), _t(fr)
    if cfg.frontend == "vision_stub":
        pa = (g.normal(size=(b, cfg.num_stub_patches, cfg.d_model)) * 0.1).astype(np.float32)
        batch["patches"], kw["patches"] = jnp.asarray(pa), _t(pa)
    return toks, batch, kw


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JModel(j_smoke(arch)).init(jax.random.key(0))


class _Jitted:
    """A JAX model's forward, prefill and decode_step under ``jax.jit`` (one
    compile per shape instead of op-by-op dispatch)."""

    def __init__(self, cfg):
        self.cfg = cfg
        m = JModel(cfg)
        self.forward = jax.jit(m.forward)
        self.prefill = jax.jit(m.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(m.decode_step)


@functools.lru_cache(maxsize=None)
def _jmodel(arch, cdt):
    return _Jitted(j_smoke(arch).replace(compute_dtype=cdt))


@pytest.fixture(scope="module", params=[(a, c) for a in ARCHS for c in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(JAX model at this compute dtype, the JAX f32 model, their params,
    the port's model with the same weights, compute dtype)."""
    arch, cdt = request.param
    params = _jax_params(arch)
    jm, j32 = _jmodel(arch, cdt), _jmodel(arch, "float32")
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype=cdt), device="cpu")
    return jm, j32, params, tm, cdt


def _check(got, jm, j32, fn, cdt):
    """Hold ``got`` to ``fn(jm)`` (f32), or to the noise band of ``fn(jm)``
    and ``fn(j32)`` (bf16)."""
    if cdt == "float32":
        _close_f32(got, fn(jm))
    else:
        _close_bf16(got, fn(jm), fn(j32))


# --------------------------------------------------------------------------
# the model, end to end
# --------------------------------------------------------------------------


def test_forward_logits_and_router_losses(pair):
    jm, j32, params, tm, cdt = pair
    toks, batch, kw = _inputs(jm.cfg, 2, 9, seed=6)
    got, aux, caches = tm.forward(_t(toks), **kw)
    assert got.shape == (2, 9, jm.cfg.padded_vocab) and got.dtype == torch.float32
    assert caches is None
    out = {}

    def fwd(m):
        out[m.cfg.compute_dtype] = m.forward(params, batch)
        return out[m.cfg.compute_dtype][0]

    _check(got, jm, j32, fwd, cdt)
    jaux = out[cdt][1]
    for name in ("router_aux", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=TIGHT if cdt == "float32" else 3e-2, atol=TIGHT)
    assert (float(aux["router_aux"]) > 0) == (jm.cfg.moe is not None)


def test_prefill_then_decode_at_per_row_positions(pair):
    """Prefill logits and the cache (positional leaves padded with zeros,
    states whole), then three decode steps with the rows at different
    positions (the serving engine's per-slot positions)."""
    jm, j32, params, tm, cdt = pair
    toks, batch, kw = _inputs(jm.cfg, 2, 6, seed=7)
    caches = {}  # the JAX caches by compute dtype

    def prefill(m):
        logits, caches[m.cfg.compute_dtype] = m.prefill(params, batch, max_len=12)
        return logits

    tlog, tcache = tm.prefill(_t(toks), max_len=12, **kw)
    _check(tlog, jm, j32, prefill, cdt)
    if cdt == "float32":  # the port's flat leaves against the JAX tree's
        jleaves = _jax_cache_leaves(tm, caches[cdt])
        for lane, jl in zip(tcache, jleaves):
            assert set(lane) == set(jl)
            for name, leaf in lane.items():
                assert leaf.shape == jl[name].shape and leaf.dtype == _dtype(jl[name])
                _close(leaf, jl[name])
    g = np.random.default_rng(8)
    pos = np.array([6, 3], np.int32)
    for _ in range(3):
        nt = g.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        td = tm.decode_step(_t(nt), tcache, _t(pos))
        assert td.shape == (2, jm.cfg.padded_vocab)

        def step(m, nt=nt, pos=pos):
            c = m.cfg.compute_dtype
            logits, caches[c] = m.decode_step(params, jnp.asarray(nt), caches[c],
                                              jnp.asarray(pos))
            return logits

        _check(td, jm, j32, step, cdt)
        pos = pos + 1


def _dtype(a):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(np.asarray(a).dtype)]


def _jax_cache_leaves(tm, jcache) -> list[dict]:
    """The JAX cache tree flattened to the port's per-sub-layer dicts."""
    out = []
    for stage, tree in zip(tm.stages, jcache):
        units = tree if isinstance(tree, list) else [
            jax.tree.map(lambda a, i=i: a[i], tree) for i in range(stage.n)]
        for u in units:
            for j in range(len(stage.unit)):
                c = u[f"u{j}"]
                if "tm" in c:
                    c = {"tm_shift": c["tm"]["shift"], "tm_wkv": c["tm"]["wkv"],
                         "cm_shift": c["cm"]["shift"]}
                out.append({k: np.asarray(v) for k, v in c.items()})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_in_f32(arch):
    """Eight greedy tokens of prefill + decode are the JAX package's."""
    params = _jax_params(arch)
    jm = _jmodel(arch, "float32")
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype="float32"), device="cpu")
    toks, batch, kw = _inputs(jm.cfg, 1, 5, seed=9)
    out = {}
    logits, cache = jm.prefill(params, batch, max_len=16)
    seq = [int(np.argmax(np.asarray(logits[0, -1])))]
    for p in range(5, 12):
        lg, cache = jm.decode_step(params, jnp.asarray([[seq[-1]]], jnp.int32), cache,
                                   jnp.int32(p))
        seq.append(int(np.argmax(np.asarray(lg[0]))))
    out["jax"] = seq
    logits, cache = tm.prefill(_t(toks), max_len=16, **kw)
    seq = [int(torch.argmax(logits[0, -1]))]
    for p in range(5, 12):
        seq.append(int(torch.argmax(tm.decode_step(_t(np.array([[seq[-1]]], np.int32)), cache, p)[0])))
    out["torch"] = seq
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------


def _moe_cfgs(factor):
    kw = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
              d_ff=32, vocab_size=64)
    mk = dict(num_experts=4, top_k=2, d_ff_expert=16, capacity_factor=factor, num_shared=1)
    return (JModelConfig(**kw, moe=JMoEConfig(**mk)), ModelConfig(**kw, moe=MoEConfig(**mk)))


def _numpy_drops(top_e, cap):
    """The JAX package's dispatch, restated in numpy: stable sort by expert,
    each expert keeps its first ``cap`` assignments in token-major order."""
    flat = top_e.reshape(-1)
    kept = np.zeros(flat.size, bool)
    for e in np.unique(flat):
        kept[np.flatnonzero(flat == e)[:cap]] = True
    return ~kept


@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_moe_capacity_drops_match_jax(factor):
    """Capacity factor 0.5 forces drops (C = 8 slots against 32 tokens x 2
    choices over 4 experts): the port drops exactly the assignments the JAX
    package drops, and its output and router losses equal the JAX
    package's; at 2.0 nothing drops."""
    jcfg, cfg = _moe_cfgs(factor)
    p = jmoe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    m = tmoe.MoE(cfg, "cpu")
    _load(m, jax.tree.map(np.asarray, p), "moe")
    m.cast(torch.float32)
    x = np.random.default_rng(0).normal(size=(2, 16, 16)).astype(np.float32)
    jout, jaux = jax.jit(jmoe.moe_ffn, static_argnums=2)(p, jnp.asarray(x), jcfg)
    out, aux = m(_t(x))
    _close(out, jout)
    for name in ("router_aux", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=TIGHT)
    top_e, _, _ = tmoe.route(_t(x).reshape(32, 16), m.router, 2)
    jtop_e = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x).reshape(32, 16)
                                                      @ p["router"], -1), 2)[1])
    np.testing.assert_array_equal(top_e.numpy(), jtop_e)
    cap = tmoe.capacity(32, 2, 4, factor)
    assert cap == jmoe._capacity(32, 2, 4, factor)
    _, valid, row = tmoe.dispatch(top_e, 4, cap)
    dropped = (row < 0).numpy()
    np.testing.assert_array_equal(dropped, _numpy_drops(jtop_e, cap))
    assert int(valid.sum()) == dropped.size - int(dropped.sum())
    assert dropped.any() == (factor < 1.0)


def test_mla_absorbed_decode_matches_jax():
    """The absorbed one-token decode over a compressed cache at per-row
    positions, the cache written in place, against ``mla_decode``; and the
    prefill's compressed pair against ``mla_forward``'s."""
    jcfg = j_smoke("deepseek-v2-236b").replace(compute_dtype="float32")
    cfg = get_smoke_config("deepseek-v2-236b").replace(compute_dtype="float32")
    p = jattn.init_mla(jax.random.key(1), jcfg, jnp.float32)
    m = MLA(cfg, "cpu")
    _load(m, jax.tree.map(np.asarray, p), "mla")
    m.cast(torch.float32)
    g = np.random.default_rng(1)
    x = g.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(7), (2, 7))
    jout, (jc, jr) = jax.jit(jattn.mla_forward, static_argnums=2)(
        p, jnp.asarray(x), jcfg, jnp.asarray(positions))
    out, (c_kv, k_rope) = m(_t(x), rope_tables(_t(positions), 8, cfg.rope_theta))
    _close(out, jout)
    _close(c_kv, jc)
    _close(k_rope, jr)
    cache = {"c_kv": g.normal(size=(2, 12, 32)).astype(np.float32),
             "k_rope": g.normal(size=(2, 12, 8)).astype(np.float32)}
    xd = g.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([7, 2], np.int32)
    jo, jnew = jax.jit(jattn.mla_decode, static_argnums=2)(p, jnp.asarray(xd), jcfg,
                                {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos))
    tc = {k: _t(v.copy()) for k, v in cache.items()}
    o = m.decode(_t(xd), tc, DecodeStep(_t(pos).long(), 12, 8, cfg.rope_theta))
    _close(o, jo)
    for k in cache:
        _close(tc[k], jnew[k])


@pytest.mark.parametrize("s", [2, 9])
def test_mamba_scan_and_decode_match_jax(s):
    """The selective scan, its final state (the conv window left-padded when
    S < d_conv - 1) and four one-token steps from it, against the JAX
    package's, with the state's shapes and dtypes."""
    jcfg = j_smoke("jamba-1.5-large-398b")
    cfg = get_smoke_config("jamba-1.5-large-398b")
    p = jmamba.init_mamba(jax.random.key(2), jcfg, jnp.float32)
    m = Mamba(cfg, "cpu")
    _load(m, jax.tree.map(np.asarray, p), "mamba")
    m.cast(torch.float32)
    g = np.random.default_rng(2)
    x = g.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    mamba_decode = jax.jit(jmamba.mamba_decode, static_argnums=2)
    jout, jst = jax.jit(jmamba.mamba_forward, static_argnums=2)(p, jnp.asarray(x), jcfg)
    out, st = m(_t(x))
    _close(out, jout)
    d_in = 2 * cfg.d_model
    assert st["conv"].shape == (2, 3, d_in) and st["ssm"].shape == (2, d_in, 4)
    assert st["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])
    empty = m.init_state(2, torch.bfloat16, "cpu")
    assert empty["conv"].dtype == torch.bfloat16 and empty["ssm"].dtype == torch.float32
    for _ in range(4):
        xd = g.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jo, jst = mamba_decode(p, jnp.asarray(xd), jcfg, jst)
        o = m.decode(_t(xd), st)
        _close(o, jo)
        for k in ("conv", "ssm"):
            _close(st[k], jst[k])


def test_rwkv_time_and_channel_mix_match_jax():
    """Time-mix over a prompt from zeros, then continued from its state, then
    one-token steps; channel-mix likewise; state shapes and dtypes."""
    jcfg = j_smoke("rwkv6-3b")
    cfg = get_smoke_config("rwkv6-3b")
    ptm = jrwkv.init_time_mix(jax.random.key(3), jcfg, jnp.float32)
    pcm = jrwkv.init_channel_mix(jax.random.key(4), jcfg, jnp.float32)
    # nonzero lerp factors and norms, so every term of the ddlerp counts
    g = np.random.default_rng(3)
    ptm = {k: (np.asarray(v) + g.normal(size=np.shape(v)).astype(np.float32) * 0.2
               if k in ("mu_x", "mu", "ln_scale", "ln_bias") else np.asarray(v))
           for k, v in ptm.items()}
    pcm = {k: np.asarray(v) + (g.normal(size=np.shape(v)).astype(np.float32) * 0.2
                               if k.startswith("mu") else 0) for k, v in pcm.items()}
    tm, cm = TimeMix(cfg, "cpu"), ChannelMix(cfg, "cpu")
    _load(tm, ptm, "tm")
    _load(cm, pcm, "cm")
    tm.cast(torch.float32)
    cm.cast(torch.float32)
    time_mix = jax.jit(jrwkv.time_mix_forward, static_argnums=2)  # decode: the same at S = 1
    channel_mix = jax.jit(jrwkv.channel_mix_forward, static_argnums=2)
    jp_tm = {k: jnp.asarray(v) for k, v in ptm.items()}
    jp_cm = {k: jnp.asarray(v) for k, v in pcm.items()}
    x = g.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    jo, jst = time_mix(jp_tm, jnp.asarray(x), jcfg)
    o, shift, wkv = tm(_t(x))
    _close(o, jo)
    _close(shift, jst["shift"])
    _close(wkv, jst["wkv"])
    assert wkv.shape == (2, 4, 16, 16) and wkv.dtype == torch.float32
    assert shift.shape == (2, 1, cfg.d_model)
    jco, jcs = channel_mix(jp_cm, jnp.asarray(x), jcfg)
    co, cs = cm(_t(x))
    _close(co, jco)
    _close(cs, jcs["shift"])
    x2 = g.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    jo, jst = time_mix(jp_tm, jnp.asarray(x2), jcfg, jst)
    o, shift, wkv = tm(_t(x2), shift, wkv)
    _close(o, jo)
    _close(wkv, jst["wkv"])
    for _ in range(3):
        xd = g.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jo, jst = time_mix(jp_tm, jnp.asarray(xd), jcfg, jst)
        o, shift, wkv = tm(_t(xd), shift, wkv)
        _close(o, jo)
        _close(wkv, jst["wkv"])
        jco, jcs = channel_mix(jp_cm, jnp.asarray(xd), jcfg, jcs)
        co, cs = cm(_t(xd), cs)
        _close(co, jco)


def test_whisper_cross_caches_match_jax():
    """Whisper's prefill caches the encoder's cross K/V (B, encoder_seq, KV,
    hd) per decoder layer, equal to the JAX package's, and decode reads
    them; frames shorter than ``encoder_seq`` leave zeros after them."""
    arch = "whisper-tiny"
    params = _jax_params(arch)
    jm = _jmodel(arch, "float32")
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype="float32"), device="cpu")
    cfg = tm.cfg
    toks, batch, kw = _inputs(cfg, 2, 4, seed=10)
    for frames in (kw["frames"], kw["frames"][:, :10]):
        b = dict(batch, frames=jnp.asarray(frames.numpy()))
        jlog, jcache = jm.prefill(params, b, max_len=8)
        tlog, tcache = tm.prefill(_t(toks), frames=frames, max_len=8)
        _close(tlog, jlog)
        assert len(tcache) == cfg.num_layers
        for i, lane in enumerate(tcache):
            assert lane["ck"].shape == (2, cfg.encoder_seq, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)
            for name in ("k", "v", "ck", "cv"):
                _close(lane[name], np.asarray(jcache[0]["u0"][name])[i])
            assert not lane["ck"][:, frames.shape[1]:].any()
        nt = np.array([[3], [7]], np.int32)
        jd, _ = jm.decode_step(params, jnp.asarray(nt), jcache, jnp.int32(4))
        _close(tm.decode_step(_t(nt), tcache, 4), jd)


def test_vision_stub_patches_replace_leading_positions():
    """Pixtral's stub: the projected patches stand in the first P positions
    (the tokens there do not matter), equal to the JAX package's."""
    arch = "pixtral-12b"
    params = _jax_params(arch)
    jm = _jmodel(arch, "float32")
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype="float32"), device="cpu")
    toks, batch, kw = _inputs(tm.cfg, 2, 9, seed=11)
    got = tm.forward(_t(toks), **kw)[0]
    _close(got, jm.forward(params, batch)[0])
    other = toks.copy()
    other[:, :tm.cfg.num_stub_patches] = 0
    assert torch.equal(tm.forward(_t(other), **kw)[0], got)
    assert not torch.equal(tm.forward(_t(toks))[0], got)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "rwkv6-3b"])
@pytest.mark.parametrize("quantized", [False, True])
def test_knn_interpolation_on_the_families(arch, quantized):
    """kNN-LM decode (f32 compute, retrieval on) on a flat f32 or int8
    datastore whose keys are the model's own decode hidden states plus
    N(0, 0.5^2) jitter: the interpolated log-probabilities equal the JAX
    package's.  Both compute d2 by the f32 expansion, whose rounding is up
    to 8 ulp of ||q||^2 + ||x||^2 (<= 3e-3 on these hidden states, against
    d2 >= 9.8 to the nearest keys): sqrt(d2) / T moves by < 5e-5 at T = 10,
    so the log-probabilities are held to ``_close_f32``'s bound."""
    base = dict(enabled=True, k=4, lam=0.25, temperature=10.0, datastore_size=256,
                quantized=quantized)
    params = _jax_params(arch)
    jcfg = j_smoke(arch).replace(compute_dtype="float32", retrieval=JRetrievalConfig(**base))
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         retrieval=RetrievalConfig(**base))
    jm = _Jitted(jcfg)
    tm = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    g = np.random.default_rng(12)
    toks = g.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    # keys: the hidden states a short decode visits, jittered, with tokens
    hidden = []
    _, cache = tm.prefill(_t(toks), max_len=12)
    orig = tm._head
    tm._head = lambda x: hidden.append(x[:, 0].clone()) or orig(x)
    try:
        for p in range(5, 9):
            tm.decode_step(_t(toks[:, :1]), cache, p)
    finally:
        tm._head = orig
    h = torch.cat(hidden).numpy()
    keys = np.concatenate([h + g.normal(size=h.shape).astype(np.float32) * 0.5
                           for _ in range(16)])
    values = g.integers(0, cfg.vocab_size, len(keys)).astype(np.int32)
    ds = build_flat_datastore(keys, values, quantized=quantized, device="cpu")
    jds = jret.build_flat_datastore(keys, values, quantized=quantized)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=12)
    _, tcache = tm.prefill(_t(toks), max_len=12)
    for p in range(5, 9):
        nt = toks[:, p - 5:p - 4]
        jd, jcache = jm.decode_step(params, jnp.asarray(nt), jcache, jnp.int32(p), datastore=jds)
        td = tm.decode_step(_t(nt), tcache, p, datastore=ds)
        _close_f32(td, jd)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "rwkv6-3b", "jamba-1.5-large-398b"])
def test_engine_two_slots_equal_one_slot(arch):
    """Continuous batching on an MoE, an SSM and a hybrid: each request's
    tokens from a 2-slot engine equal a 1-slot engine's (greedy, f32)."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    model = Model(cfg, device="cpu", seed=4)
    g = np.random.default_rng(13)
    prompts = [g.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3, 7)]
    out = {}
    for slots in (1, 2):
        eng = ServeEngine(model, num_slots=slots, max_len=32)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        out[slots] = [r.out_tokens for r in reqs]
    assert out[2] == out[1]


def test_weights_held_in_param_dtype_without_second_copies():
    """bf16 params with bf16 compute: the compute weights ARE the parameters
    (no cast copy, no fused copy), the f32 leaves stay f32, and the JAX
    package's parameter count is the port's."""
    cfg = get_smoke_config("deepseek-v2-236b").replace(param_dtype="bfloat16")
    m = Model(cfg, device="cpu", seed=0)
    jcount = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
        JModel(j_smoke("deepseek-v2-236b")).init, jax.random.key(0))))
    assert sum(p.numel() for p in m.parameters()) == jcount
    f32 = {n for n, p in m.named_parameters() if p.dtype == torch.float32}
    assert all(n.split(".")[-1] in ("final_norm", "ln1", "ln2", "router") for n in f32)
    ptrs = {p.data_ptr() for p in m.parameters()}
    for layer in m.layers:
        for mod in layer.modules():
            for w in getattr(mod, "c", {}).values():
                assert w.data_ptr() in ptrs
    rw = Model(get_smoke_config("rwkv6-3b"), device="cpu", seed=0)  # f32 params, bf16 compute
    assert rw.layers[0].tm.c["wr"].dtype == torch.bfloat16 and rw.layers[0].tm.wr.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_every_decoder_only_arch(arch, capsys):
    """``launch/serve.py --arch`` at the smoke widths on the host, retrieval
    on an int8 store: every decoder-only family completes its requests;
    whisper-tiny, which needs frames the engine does not take, is refused
    with a message naming ``Model.prefill``."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--device", "cpu", "--arch", arch, "--requests", "2", "--new-tokens", "3",
            "--quantized-datastore"]
    if arch == "whisper-tiny":
        with pytest.raises(SystemExit):
            launch_serve.main(argv)
        assert "Model.prefill" in capsys.readouterr().err
        return
    launch_serve.main(argv)
    assert "2 requests, 6 tokens" in capsys.readouterr().out
