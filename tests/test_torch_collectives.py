"""The port's island collectives (``repro_torch.distributed.collectives``)
on ``["cpu"] * 4`` islands against the JAX package's helpers under
``shard_map`` on 4 host devices (a child process): the two gathers and the
top-k merge exactly, ties across islands included in ``lax.top_k``'s order;
``compressed_psum`` within 2e-2 of the f32 sum (the JAX package's own
tolerance) and within one bf16 rounding of the JAX result, in the input's
dtype."""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as col

from torch_jax_child import run_child

N = 4

CHILD = """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed import collectives as col
from repro.distributed.context import shard_map
mesh = jax.make_mesh((4,), ("x",))
def run(f, *xs, n_out=1):
    spec = P("x")
    outs = shard_map(lambda *a: f(*[v[0] for v in a]), mesh=mesh,
                     in_specs=tuple(spec for _ in xs),
                     out_specs=tuple(spec for _ in range(n_out)) if n_out > 1 else spec,
                     check_vma=False)(*[jnp.asarray(x) for x in xs])
    return outs
ps = run(lambda x: col.compressed_psum(x, "x")[None], IN["psum"])
ag = run(lambda x: col.ring_allgather_pipelined(x, "x", chunks=4)[None], IN["gather"])
ag3 = run(lambda x: col.ring_allgather_pipelined(x, "x", chunks=3)[None], IN["gather"])
tv, tp = run(lambda v, p: tuple(o[None] for o in col.topk_allgather_merge(v, p, "x", k=5)),
             IN["vals"], IN["payload"], n_out=2)
save(psum=np.asarray(ps, np.float32), gather=np.asarray(ag), gather3=np.asarray(ag3),
     tv=np.asarray(tv), tp=np.asarray(tp))
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    vals = np.sort(np.round(rng.normal(size=(N, 6, 5)) * 4) / 4, axis=2).astype(np.float32)
    vals[1, :, 0] = vals[0, :, 0]  # ties across islands
    vals[3, :, :2] = vals[0, :, 1:2]
    inputs = {
        "psum": rng.normal(size=(N, 8, 33)).astype(np.float32),
        "gather": rng.normal(size=(N, 8, 3)).astype(np.float32),
        "vals": vals,
        "payload": rng.integers(0, 1000, size=(N, 6, 5)).astype(np.int32),
    }
    ref = run_child(CHILD, tmp_path_factory.mktemp("col"), devices=N, inputs=inputs)
    return inputs, ref


def _islands(a):
    return [torch.from_numpy(a[s].copy()) for s in range(N)]


def test_compressed_psum(data):
    inputs, ref = data
    got = col.compressed_psum(_islands(inputs["psum"]))
    exact = inputs["psum"].sum(0)
    for g in got:
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), exact, rtol=2e-2, atol=2e-2)
        # one bf16 rounding of the sum: 2^-8 relative
        np.testing.assert_allclose(g.numpy(), ref["psum"][0], rtol=2 ** -7, atol=1e-6)
    assert col.compressed_psum([torch.ones(2, dtype=torch.bfloat16)] * N)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("chunks,key", [(4, "gather"), (3, "gather3")])
def test_ring_allgather_pipelined(data, chunks, key):
    inputs, ref = data
    got = col.ring_allgather_pipelined(_islands(inputs["gather"]), chunks=chunks)
    for s, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), ref[key][s])
        np.testing.assert_array_equal(g.numpy(), inputs["gather"].reshape(-1, 3))


def test_topk_allgather_merge_ties(data):
    inputs, ref = data
    tv, tp = col.topk_allgather_merge(_islands(inputs["vals"]), _islands(inputs["payload"]), k=5)
    for s in range(N):
        np.testing.assert_array_equal(tv[s].numpy(), ref["tv"][s])
        np.testing.assert_array_equal(tp[s].numpy(), ref["tp"][s])
