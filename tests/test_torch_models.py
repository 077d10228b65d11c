"""The port's LM (``repro_torch.models``) against the JAX package's, with the
JAX weights carried across by ``params_from_jax``.

Inputs are made with numpy and handed to both.  Tolerances: with
``compute_dtype="float32"`` the two frameworks run the same f32 arithmetic
in different summation orders, so logits and activations agree to
``atol = rtol = 1e-5`` (observed ~3e-7) and greedy decoding picks the same
tokens.  Under the default bf16 compute both round activations to bf16 at
the same places, but their bf16 products differ in the last bit, which
compounds over layers: logits (|logit| < 1 at init) agree to ``atol =
3e-2`` (observed ~6e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.models.attention import DecodeStep
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

TIGHT = 1e-5
BF16 = 3e-2
ARCHS = ["qwen2-0.5b", "smollm-135m"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=[(a, c) for a in ARCHS for c in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(JAX model, its params, the port's model with the same weights)."""
    arch, cdt = request.param
    jm = JModel(j_smoke(arch).replace(compute_dtype=cdt))
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype=cdt), device="cpu")
    return jm, params, tm, (TIGHT if cdt == "float32" else BF16)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    g = np.random.default_rng(0)
    x = g.normal(size=(2, 5, 16)).astype(np.float32)
    s = g.normal(size=(16,)).astype(np.float32) * 0.1
    want = jl.rms_norm(jnp.asarray(x, jl.dtype_of(dtype)), jnp.asarray(s), 1e-5)
    got = tl.rms_norm(_t(x).to(tl.dtype_of(dtype)), _t(s), 1e-5)
    assert got.dtype == tl.dtype_of(dtype)
    _close(got, want.astype(jnp.float32), TIGHT if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_per_row_positions(theta):
    g = np.random.default_rng(1)
    x = g.normal(size=(3, 4, 2, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [200, 201, 202, 203]], np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.rotate(_t(x), *tl.rope_tables(_t(pos), 16, theta))
    # angles up to 203 rad: cos/sin of f32 arguments differ by ~1 ulp of the angle
    _close(got, want, 1e-4)


def test_mlp_swiglu_matches():
    """The port's one (D, 2F) product for gate and input gives the JAX
    package's two."""
    g = np.random.default_rng(2)
    p = {k: g.normal(size=s).astype(np.float32) * 0.2
         for k, s in (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    x = g.normal(size=(2, 3, 16)).astype(np.float32)
    want = jl.mlp_swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tl.mlp_swiglu(_t(np.concatenate([p["w_gate"], p["w_in"]], 1)), _t(p["w_out"]), _t(x))
    _close(got, want, TIGHT)


@pytest.mark.parametrize("kv_block", [4, 1024])
def test_chunked_attention_matches(kv_block):
    """Several KV blocks (the online-softmax recurrence) and one."""
    g = np.random.default_rng(3)
    q = g.normal(size=(2, 10, 4, 8)).astype(np.float32)
    k = g.normal(size=(2, 10, 2, 8)).astype(np.float32)
    v = g.normal(size=(2, 10, 2, 8)).astype(np.float32)
    want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, kv_block=kv_block)
    got = tl.chunked_attention(_t(q), _t(k), _t(v), causal=True, kv_block=kv_block)
    _close(got, want, TIGHT)


def test_decode_attention_matches_and_equals_prefill_row():
    """Per-row cache lengths mask what lies past them; the decode of the last
    prompt position equals that row of the causal prefill attention."""
    g = np.random.default_rng(4)
    k = g.normal(size=(3, 12, 2, 8)).astype(np.float32)
    v = g.normal(size=(3, 12, 2, 8)).astype(np.float32)
    q = g.normal(size=(3, 1, 4, 8)).astype(np.float32)
    cur = np.array([1, 7, 12], np.int32)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur))
    got = tl.decode_attention(_t(q), _t(k), _t(v), tl.decode_mask(_t(cur), 12))
    _close(got, want, TIGHT)
    qs = g.normal(size=(1, 7, 4, 8)).astype(np.float32)
    full = tl.chunked_attention(_t(qs), _t(k[1:2, :7]), _t(v[1:2, :7]), causal=True)
    one = tl.decode_attention(_t(qs[:, 6:7]), _t(k[1:2]), _t(v[1:2]),
                              tl.decode_mask(_t(np.array([7])), 12))
    _close(one, full[:, 6:7].numpy(), TIGHT)


def test_cache_write_matches_masked_select():
    """Each row writes at its own position; a position outside the cache
    writes nothing, as the JAX package's masked select (``cache_update``)."""
    g = np.random.default_rng(5)
    cache = g.normal(size=(4, 6, 2, 4)).astype(np.float32)
    new = g.normal(size=(4, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 5, 6, -1], np.int32)
    want = jattn.cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    step = DecodeStep(_t(pos).long(), max_len=6, head_dim=4, theta=1e4)
    got = step.write_(_t(cache.copy()), _t(new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_forward_logits_match(pair):
    jm, params, tm, tol = pair
    toks = np.random.default_rng(6).integers(0, jm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jl_, _, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, aux, caches = tm.forward(_t(toks))
    assert got.shape == (2, 9, jm.cfg.padded_vocab) and got.dtype == torch.float32
    assert caches is None
    assert float(aux["router_aux"]) == float(aux["router_z"]) == 0.0  # no MoE layer
    _close(got, jl_, tol)


def test_prefill_then_decode_match_at_per_row_positions(pair):
    """Prefill logits and the padded cache, then two decode steps with the
    rows at different positions (the serving engine's per-slot positions)."""
    jm, params, tm, tol = pair
    g = np.random.default_rng(7)
    toks = g.integers(0, jm.cfg.vocab_size, (2, 6)).astype(np.int32)
    jlog, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=12)
    tlog, tcache = tm.prefill(_t(toks), max_len=12)
    _close(tlog, jlog, tol)
    jk = np.asarray(jcache[0]["u0"]["k"])  # scanned stage: (L, B, S, KV, hd)
    for i, lane in enumerate(tcache):
        assert lane["k"].shape == (2, 12, jm.cfg.num_kv_heads, jm.cfg.resolved_head_dim)
        _close(lane["k"], jk[i].astype(np.float32), tol)
        assert not lane["k"][:, 6:].any()  # zero past the prompt
    pos = np.array([6, 3], np.int32)  # row 1 re-decodes from position 3
    for step in range(2):
        nt = g.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jd, jcache = jm.decode_step(params, jnp.asarray(nt), jcache, jnp.asarray(pos))
        td = tm.decode_step(_t(nt), tcache, _t(pos))
        assert td.shape == (2, jm.cfg.padded_vocab)
        _close(td, jd, tol)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_in_f32(arch):
    """Eight greedy tokens of prefill + decode are the JAX package's."""
    jcfg = j_smoke(arch).replace(compute_dtype="float32", scan_layers=False)
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(3))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         get_smoke_config(arch).replace(compute_dtype="float32",
                                                        scan_layers=False), device="cpu")
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 5)).astype(np.int32)
    out = {}
    for name, prefill, step in (
        ("jax", lambda: jm.prefill(params, {"tokens": jnp.asarray(prompt)}, max_len=16),
         lambda t, c, p: jm.decode_step(params, jnp.asarray([[t]], jnp.int32), c, jnp.int32(p))),
        ("torch", lambda: tm.prefill(_t(prompt), max_len=16),
         lambda t, c, p: (tm.decode_step(_t(np.array([[t]], np.int32)), c, p), c)),
    ):
        logits, cache = prefill()
        toks = [int(np.argmax(np.asarray(logits[0, -1])))]
        for p in range(5, 12):
            lg, cache = step(toks[-1], cache, p)
            toks.append(int(np.argmax(np.asarray(lg[0]))))
        out[name] = toks
    assert out["torch"] == out["jax"]


def test_seeded_init_draws_the_jax_distributions():
    """The port's own init (no JAX on the card): N(0, 0.02^2) embedding,
    ``dense_init`` scales, zero norms and biases; a seed repeats."""
    cfg = get_smoke_config("qwen2-0.5b").replace(d_model=256, num_heads=4, d_ff=512)
    m = Model(cfg, device="cpu", seed=11)
    assert abs(float(m.embed.std()) - 0.02) < 1e-3
    layer = m.layers[0]
    d = cfg.d_model
    assert abs(float(layer.attn.wq.std()) - d**-0.5) < 0.05 * d**-0.5
    hd_all = cfg.num_heads * cfg.resolved_head_dim
    assert abs(float(layer.attn.wo.std()) - hd_all**-0.5) < 0.05 * hd_all**-0.5
    assert abs(float(layer.mlp.w_out.std()) - cfg.d_ff**-0.5) < 0.05 * cfg.d_ff**-0.5
    assert not m.final_norm.any() and not layer.ln1.any() and not layer.attn.bq.any()
    again = Model(cfg, device="cpu", seed=11)
    assert torch.equal(m.layers[1].mlp.w_in, again.layers[1].mlp.w_in)


def test_full_configs_and_unported_archs():
    """Every architecture of the JAX package's zoo is ported: each of the
    port's ten configuration modules equals the JAX package's ``CONFIG``
    and ``SMOKE_CONFIG`` field for field (sub-configs included), and an
    unknown architecture still raises ``KeyError``."""
    import dataclasses

    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get_config as j_config
    from repro_torch.configs import ARCH_IDS, PORTED

    assert ARCH_IDS == J_ARCH_IDS and set(PORTED) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        for port, ref in ((get_config(arch), j_config(arch)),
                          (get_smoke_config(arch), j_smoke(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert [f.name for f in dataclasses.fields(port)] == \
                [f.name for f in dataclasses.fields(ref)]
    cfg = get_config("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.padded_vocab, cfg.qkv_bias, cfg.tie_embeddings) == (
        24, 896, 14, 2, 4864, 151_936, True, True)  # 151,936 = 1,187 x 128: no padding
    with pytest.raises(KeyError):
        get_config("gpt-17")
    with pytest.raises(KeyError):
        get_smoke_config("gpt-17")
