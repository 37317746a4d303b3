"""The port's collective API against the JAX reference's, over 4 gloo
ranks started by the port's launcher (tests/torch_dist_worker.py), the
reference at the same degree (dp 4 of the fake CPU devices).

The correspondence rule (``paddle_tpu_torch/distributed/collective.py``):
the reference's tensors are global, a tensor sharded over dp one array
whose r-th block of the sharded dim is rank r's part; the port's rank r
holds that block alone and a replicated tensor whole. So the
reference's result is the concatenation of the ranks' results along the
sharded dim, and a replicated result equals each rank's. Every case of
tests/test_distributed_collective.py that needs no auto-parallel name
(its sharded inputs placed here with ``jax.device_put``) is held so,
exactly for fp32 and integers; the other ops of the API (the split
all-to-all, the list all-to-all, scatter, reduce, the point-to-point
pairs, ``all_gather_object``, the async task) against their definition
on the ranks' inputs.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as ref
import paddle_tpu.distributed as jdist

import torch_dist_common as C

N = 4
CASES = [dict(name="collective", kind="collective")]


def _place(x, g):
    t = ref.to_tensor(x)
    t._bump(jax.device_put(t._data, NamedSharding(g.mesh, P("dp"))))
    return t


def _reference():
    """The reference's results of the same cases, at dp 4."""
    from paddle_tpu.distributed import parallel as jpar
    from paddle_tpu.distributed import topology as jtop

    old = (jpar._DEFAULT_GROUP, jtop.get_hybrid_communicate_group())
    try:
        jdist.init_parallel_env({"dp": N})
        g = jdist.new_group(axis_names=("dp",))
        out = {"world": (jdist.get_world_size(), jdist.get_rank())}
        t = ref.to_tensor(np.full((4, 3), 2.0, np.float32))
        jdist.all_reduce(t)
        out["ar_sum"] = t.numpy()
        t = ref.to_tensor(np.full((2,), 3.0, np.float32))
        jdist.all_reduce(t, op=jdist.ReduceOp.MAX)
        out["ar_max"] = t.numpy()
        for dt in ("float32", "int32"):
            x = np.arange(16).reshape(8, 2).astype(dt)
            ops = ("SUM", "MAX", "MIN", "PROD", "AVG") if dt == "float32" \
                else ("SUM", "MAX", "MIN")
            for op in ops:
                t = _place(x, g)
                jdist.all_reduce(t, op=getattr(jdist.ReduceOp, op), group=g)
                out[f"ar_shard_{op}_{dt}"] = t.numpy()
        lst = []
        jdist.all_gather(lst, ref.to_tensor(np.arange(6, dtype=np.float32)
                                            .reshape(2, 3)))
        out["ag_rep"] = np.stack([o.numpy() for o in lst])
        x = np.arange(16, dtype=np.float32).reshape(16, 1)
        out["ag_shard"] = jdist.all_gather(_place(x, g), group=g).wait() \
            .numpy()
        out["rs"] = jdist.reduce_scatter(
            ref.to_tensor(np.ones((8, 2), np.float32))).wait().numpy()
        x = np.arange(8, dtype=np.float32).reshape(8, 1)
        t = _place(x, g)
        jdist.broadcast(t, src=2, group=g)
        out["bc"] = t.numpy()
        x = np.arange(16, dtype=np.float32)
        out["a2a"] = jdist.alltoall_single(ref.to_tensor(x), group=g) \
            .wait().numpy()
        t = ref.to_tensor(np.full(3, 2.0, np.float32))
        jdist.reduce(t, dst=1, group=g)
        out["reduce_replicated"] = t.numpy()
        t = ref.to_tensor(np.full(2, 5.0, np.float32))
        jdist.send(t, dst=3, group=g)
        r = ref.to_tensor(np.zeros(2, np.float32))
        jdist.recv(r, src=0, group=g)
        out["p2p"] = r.numpy()
        jdist.barrier()
        return out
    finally:
        jpar._DEFAULT_GROUP = old[0]
        jtop.set_hybrid_communicate_group(old[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collective"))
    refs = C.launch(root, CASES, N, {"collective": _reference})
    return root, refs["collective"], [C.result(root, "collective", r)
                                      for r in range(N)]


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], 0)


def test_world_size_and_rank(runs):
    _, want, ranks = runs
    for r, got in enumerate(ranks):
        assert got["world"].tolist() == [N, r, r, N]
    # the reference's single controller answers rank 0: rank 0's
    assert tuple(ranks[0]["world"][:2]) == want["world"]


def test_all_reduce_replicated(runs):
    _, want, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got["ar_sum"], want["ar_sum"])
        np.testing.assert_array_equal(got["ar_max"], want["ar_max"])
        assert got["ar_inplace"].tolist() == [True]


SHARDED = [(op, "float32") for op in ("SUM", "MAX", "MIN", "PROD", "AVG")] \
    + [(op, "int32") for op in ("SUM", "MAX", "MIN")]


@pytest.mark.parametrize("op,dt", SHARDED,
                         ids=[f"{o}-{d}" for o, d in SHARDED])
def test_all_reduce_sharded(runs, op, dt):
    """Every rank gets the reduction of the blocks: the reference's
    tensor is that reduction repeated a block at a time."""
    _, want, ranks = runs
    key = f"ar_shard_{op}_{dt}"
    np.testing.assert_array_equal(_cat(ranks, key), want[key])
    assert ranks[0][key].dtype == want[key].dtype


def test_all_gather(runs):
    _, want, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got["ag_rep"], want["ag_rep"])
        np.testing.assert_array_equal(got["ag_shard"], want["ag_shard"])


def test_reduce_scatter(runs):
    _, want, ranks = runs
    np.testing.assert_array_equal(_cat(ranks, "rs"), want["rs"])
    # the list form, MAX: rank r keeps max over ranks of (rank + r)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rs_list_max"],
                                      np.full((2, 2), N - 1.0 + r))


def test_broadcast_sharded(runs):
    _, want, ranks = runs
    np.testing.assert_array_equal(_cat(ranks, "bc"), want["bc"])


def test_alltoall_single(runs):
    _, want, ranks = runs
    np.testing.assert_array_equal(_cat(ranks, "a2a"), want["a2a"])
    for r, got in enumerate(ranks):
        # rank r receives column r of the 4 x 4 block matrix
        np.testing.assert_array_equal(
            got["a2a"], np.arange(16).reshape(4, 4)[:, r])


def test_alltoall_single_split_sizes(runs):
    """Rank j sends rows [sum_{k<r}(k + 1), + r + 1) of its input to rank
    r; rank r concatenates them in rank order."""
    _, _, ranks = runs
    for r, got in enumerate(ranks):
        start = sum(k + 1 for k in range(r))
        want = np.concatenate([100 * j + np.arange(start, start + r + 1)
                               for j in range(N)])
        np.testing.assert_array_equal(got["a2a_split"], want)


def test_alltoall_list_scatter_reduce(runs):
    _, want, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            got["a2a_list"], np.stack([np.full(2, 10.0 * k + r)
                                       for k in range(N)]))
        np.testing.assert_array_equal(got["scatter"],
                                      np.full(2, 10.0 * r + 1))
        # the sum on dst; the others keep their tensor
        np.testing.assert_array_equal(
            got["reduce"], np.full(3, 10.0) if r == 1 else
            np.full(3, r + 1.0))
    # a replicated input: dst holds the reference's (its all-reduce)
    np.testing.assert_array_equal(ranks[1]["reduce_rep"],
                                  want["reduce_replicated"])


def test_send_recv(runs):
    _, want, ranks = runs
    np.testing.assert_array_equal(ranks[3]["p2p"], want["p2p"])
    np.testing.assert_array_equal(ranks[0]["p2p"], want["p2p"])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ring"],
                                      np.full(3, 7.0 + (r - 1) % N))


def test_objects_async_and_barrier(runs):
    _, _, ranks = runs
    for got in ranks:
        assert got["objects"].tolist() == list(range(N))
        assert got["async"].tolist() == [True, True]
        np.testing.assert_array_equal(got["async_value"], np.full(2, 4.0))


def test_spawn_two_ranks(tmp_path):
    """``distributed.spawn`` starts the ranks (torch.multiprocessing), each
    joined through ``init_parallel_env`` (gloo on the CPU), and runs the
    function on every one of them."""
    from paddle_tpu_torch import distributed as pdist

    assert pdist.spawn(C.spawned_rank, args=(str(tmp_path),), nprocs=2,
                       device="cpu") is None
    for r in range(2):
        got = np.load(tmp_path / f"spawn.r{r}.npz")
        assert got["world"].tolist() == [2, r]
        np.testing.assert_array_equal(got["sum"], np.full(3, 3.0, np.float32))
