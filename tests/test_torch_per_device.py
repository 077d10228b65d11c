"""The per-device programs the dry-run runs on DTensors, run island by
island on four CPU islands of a (2, 2) mesh (``distributed.context.
shard_map``'s island path, the same bodies and specs), against the plain
single-device functions on the same seeded inputs (f32, to 1e-5):

* the attention core: the query heads split over 'model', the KV heads
  whole (GQA: each device takes its heads' groups, by a slice of the KV
  heads, one KV head, or the KV head of each query head gathered) or
  split with the queries (MLA);
* a decode step over a cache whose positions are split over 'model' (the
  softmax's max and sum reduced across the islands), GQA's and MLA's
  absorbed one;
* the fused QKV projection (each device its query heads and every KV
  head), the SwiGLU (a block of each half of the fused weight), the head
  (tied and untied), the loss's negative log-likelihood over a vocabulary
  split over 'model' (and its gradient), RWKV's time and channel mixes and
  Mamba's scan;
* ``shard_map``'s ``pmax`` and an output sharded along two dims.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import Mesh
from repro_torch.launch.dryrun import _reset_rules
from repro_torch.models import attention as attn
from repro_torch.models import mamba, rwkv
from repro_torch.models.layers import (
    chunked_attention,
    decode_attention,
    decode_mask,
    mlp_swiglu,
    swiglu_per_device,
)
from repro_torch.models.model import _nll, head_per_device, nll_per_device

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def rules():
    _reset_rules()


def mesh():
    return Mesh(["cpu"] * 4, shape=(2, 2), axis_names=("data", "model"))


def rand(g, *shape, scale=1.0):
    return torch.from_numpy(g.normal(size=shape).astype(np.float32) * scale)


def close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,kv,kv_split", [(4, 2, False), (4, 1, False), (6, 2, False),
                                           (12, 3, False), (4, 4, True)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_per_device(h, kv, kv_split, causal):
    g = np.random.default_rng(h * 10 + kv)
    q, k, v = rand(g, 2, 24, h, 8), rand(g, 2, 24, kv, 8), rand(g, 2, 24, kv, 8)
    got = attn.attention_per_device(mesh(), q, k, v, causal=causal, kv_split=kv_split)
    close(got, chunked_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1)])
def test_decode_per_device(h, kv):
    g = np.random.default_rng(7)
    q, k, v = rand(g, 2, 1, h, 8), rand(g, 2, 32, kv, 8), rand(g, 2, 32, kv, 8)
    mask = decode_mask(torch.tensor([5, 20]) + 1, 32)
    close(attn.decode_per_device(mesh(), q, k, v, mask), decode_attention(q, k, v, mask))


def test_mla_decode_per_device():
    g = np.random.default_rng(8)
    q_abs, q_rope = rand(g, 2, 1, 4, 16), rand(g, 2, 1, 4, 8)
    c, r = rand(g, 2, 32, 16), rand(g, 2, 32, 8)
    mask = decode_mask(torch.tensor([9, 31]) + 1, 32)
    scores = (torch.einsum("bshr,btr->bhst", q_abs, c)
              + torch.einsum("bshk,btk->bhst", q_rope, r)) * 0.3
    p = torch.softmax(torch.where(mask, scores, attn.NEG_INF), dim=-1)
    want = torch.einsum("bhst,btr->bshr", p, c)
    close(attn.mla_decode_per_device(mesh(), 0.3, q_abs, q_rope, c, r, mask), want)


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_per_device(bias):
    cfg = get_smoke_config("qwen2-0.5b").replace(qkv_bias=bias, compute_dtype="float32")
    layer = attn.GQA(cfg, device="cpu")
    layer.init_(torch.Generator().manual_seed(3))
    layer.cdt = torch.float32
    w = layer.weights(torch.float32)
    if bias:
        w["bqkv"] = rand(np.random.default_rng(4), *w["bqkv"].shape)
    x = rand(np.random.default_rng(5), 2, 16, cfg.d_model)
    y = x @ w["wqkv"] + (w["bqkv"] if bias else 0)
    want = [t.reshape(2, 16, -1, layer.hd) for t in torch.split(y, layer.split, dim=-1)]
    for a, b in zip(layer.qkv_per_device(mesh(), w, x), want):
        close(a, b)
    close(layer.qkv_per_device(mesh(), w, x, kv=False)[0], want[0])


def test_swiglu_per_device():
    g = np.random.default_rng(6)
    x, wgi, wo = rand(g, 2, 16, 32), rand(g, 32, 2 * 48, scale=0.2), rand(g, 48, 32, scale=0.2)
    close(swiglu_per_device(mesh(), wgi, wo, x), mlp_swiglu(wgi, wo, x))


@pytest.mark.parametrize("tied", [True, False])
def test_head_per_device(tied):
    g = np.random.default_rng(9)
    x = rand(g, 2, 8, 16)
    w = rand(g, 64, 16) if tied else rand(g, 16, 64)
    want = torch.einsum("bsd,vd->bsv", x, w) if tied else x @ w
    close(head_per_device(mesh(), x, w, tied), want)


def test_nll_per_device_and_its_gradient():
    g = np.random.default_rng(14)
    logits = (rand(g, 2, 8, 64) * 3).requires_grad_()
    targets = torch.from_numpy(g.integers(0, 64, (2, 8)))
    got, want = nll_per_device(mesh(), logits, targets), _nll(logits, targets)
    close(got, want)
    close(torch.autograd.grad(got.sum(), logits)[0], torch.autograd.grad(want.sum(), logits)[0])


def test_rwkv_mixes_per_device():
    cfg = get_smoke_config("rwkv6-3b").replace(compute_dtype="float32")
    tm, cm = rwkv.TimeMix(cfg, device="cpu"), rwkv.ChannelMix(cfg, device="cpu")
    gen = torch.Generator().manual_seed(10)
    tm.init_(gen)
    cm.init_(gen)
    with torch.no_grad():
        tm.mu.normal_(generator=gen).mul_(0.1)
    tm.cdt = cm.cdt = torch.float32
    g = np.random.default_rng(11)
    x, shift = rand(g, 2, 12, cfg.d_model), rand(g, 2, 1, cfg.d_model)
    wkv = rand(g, 2, tm.h, tm.hd, tm.hd, scale=0.1)
    p = {**tm.weights(torch.float32), **{n: getattr(tm, n) for n in tm.F32}}
    for a, b in zip(tm.mix_per_device(mesh(), p, x, shift, wkv), tm._mix(p, x, shift, wkv)):
        close(a, b)
    w = cm.weights(torch.float32)
    args = (x, shift, w["wk"], w["wv"], w["wr"], cm.mu_k, cm.mu_r)
    for a, b in zip(rwkv.channel_mix_per_device(mesh(), *args), rwkv.channel_mix(*args)):
        close(a, b)


def test_selective_scan_per_device():
    g = np.random.default_rng(12)
    uf, delta = rand(g, 2, 10, 16), rand(g, 2, 10, 16, scale=0.1).abs()
    b_in, c_in, a = rand(g, 2, 10, 4), rand(g, 2, 10, 4), -rand(g, 16, 4).abs()
    for got, want in zip(mamba.selective_scan_per_device(mesh(), uf, delta, b_in, c_in, a),
                         mamba.selective_scan(uf, delta, b_in, c_in, a)):
        close(got, want)


def test_shard_map_pmax_and_two_sharded_dims():
    def body(ix, x):
        top = yield ("pmax", ("model",), x.amax(-1, keepdim=True))
        return x - top, top

    x = rand(np.random.default_rng(13), 4, 6)
    out, top = dctx.shard_map(body, mesh(), [("data", "model")],
                              [(("data", "model"), ()), (("data", None), ())])(x)
    close(top, x.amax(-1, keepdim=True))
    close(out, x - x.amax(-1, keepdim=True))
