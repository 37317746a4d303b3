"""The port's hybrid topology against the JAX reference's: for a table
of (data, pipe, sharding, sep, model) degrees, ``HybridCommunicateGroup``'s
degrees, axis groups (size, axis names, name, id), check group, mesh
and ``get_parallel_mode`` equal the reference's; ``new_group`` and
``get_group`` as the reference's. Over four gloo ranks started by the
port's launcher (tests/torch_sharded_worker.py), each axis group and the
check group hold the process group of the ranks that share the other
coordinates (an all-reduce over it sums its size), and the rank getters
return the calling process's coordinates on the row-major mesh."""

import os

import numpy as np
import pytest

import torch_sharded_common as C
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed import topology as jtp
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import topology as ttp

DIMS = [(1, 1, 1, 1, 1), (8, 1, 1, 1, 1), (2, 2, 1, 1, 2), (1, 1, 1, 8, 1),
        (1, 1, 4, 1, 1), (1, 2, 1, 1, 4), (2, 1, 1, 2, 2), (1, 1, 1, 2, 4),
        (1, 1, 2, 1, 2), (1, 2, 1, 2, 1), (2, 1, 2, 1, 1), (1, 4, 2, 1, 1)]
GETTERS = ("get_data_parallel_world_size", "get_model_parallel_world_size",
           "get_pipe_parallel_world_size",
           "get_sharding_parallel_world_size",
           "get_sep_parallel_world_size", "get_parallel_mode")
GROUPS = ("get_data_parallel_group", "get_model_parallel_group",
          "get_pipe_parallel_group", "get_sharding_parallel_group",
          "get_sep_parallel_group", "get_check_parallel_group")


def _group(g):
    return (g.nranks, g.world_size, g.axis_names, g.name, g.id)


@pytest.mark.parametrize("dims", DIMS, ids=["x".join(map(str, d))
                                            for d in DIMS])
def test_hybrid_group_matches_the_reference(dims):
    j = jtp.HybridCommunicateGroup(jtp.CommunicateTopology(dims=dims))
    t = ttp.HybridCommunicateGroup(ttp.CommunicateTopology(dims=dims))
    for name in GETTERS:
        assert getattr(t, name)() == getattr(j, name)(), name
    for name in GROUPS:
        assert _group(getattr(t, name)()) == _group(getattr(j, name)()), name
    assert t.mesh.axis_names == tuple(j.mesh.axis_names)
    assert t.mesh.shape == dict(j.mesh.shape)
    assert repr(t) == repr(j)
    topo = t.topology
    assert topo.get_hybrid_group_names() == \
        j.topology.get_hybrid_group_names()
    assert topo.world_size() == j.topology.world_size()
    for n in ttp.HYBRID_AXES:
        assert topo.get_dim(n) == topo.get_dim_size(n) == \
            j.topology.get_dim(n)
    # one process: coordinate 0 on every axis, as the reference's
    # single controller answers
    for name in ("get_global_rank", "get_data_parallel_rank",
                 "get_model_parallel_rank", "get_stage_id",
                 "get_sharding_parallel_rank"):
        assert getattr(t, name)() == getattr(j, name)() == 0, name


def test_parallel_mode_constants_and_the_global_slot():
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL", "SEGMENT_PARALLEL"):
        assert getattr(ttp.ParallelMode, name) == \
            getattr(jtp.ParallelMode, name)
    assert ttp.HYBRID_AXES == jtp.HYBRID_AXES
    assert ttp.AXIS_ALIAS == jtp.AXIS_ALIAS
    hcg = ttp.HybridCommunicateGroup(ttp.CommunicateTopology(
        dims=(1, 2, 1, 1, 2)))
    old = ttp.get_hybrid_communicate_group()
    ttp.set_hybrid_communicate_group(hcg)
    try:
        assert ttp.get_hybrid_communicate_group() is hcg
        # new_group defaults to the topology's mesh, as the reference's
        # to its default group's
        g = tcoll.new_group(axis_names=("pp", "mp"))
        assert g.nranks == 4 and g.axis_names == ("pp", "mp")
        assert tcoll.get_group(g.id) is g
        assert tcoll.new_group().nranks == 4
    finally:
        ttp.set_hybrid_communicate_group(old)


def test_new_group_matches_the_reference():
    from paddle_tpu.distributed.process_mesh import build_mesh as jbuild
    from paddle_tpu_torch.distributed.process_mesh import build_mesh

    jm = jbuild((2, 4), ("dp", "mp"))
    tm = build_mesh((2, 4), ("dp", "mp"))
    for axes in (("dp",), ("mp",), ("dp", "mp"), None):
        j = jcoll.new_group(axis_names=axes, mesh=jm)
        t = tcoll.new_group(axis_names=axes, mesh=tm)
        assert (t.nranks, t.world_size, t.axis_names) == \
            (j.nranks, j.world_size, j.axis_names)
        assert t.rank == j.rank == 0
        assert tcoll.get_group(t.id) is t
        assert repr(t) == repr(j)
    g = tcoll.new_group(axis_names=("mp",), mesh=tm)
    assert g.ranks == [0, 1, 2, 3] and g.get_group_rank(2) == 2
    assert g.get_group_rank(5) == -1 and g.is_member()


CASES = [dict(name=f"topo_{'x'.join(map(str, d))}", kind="topology",
              dims=list(d))
         for d in ((2, 1, 1, 2, 1), (1, 2, 1, 1, 2), (1, 1, 2, 1, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("topo"))
    assert C.launch(root, CASES, nprocs=4, timeout=120) == 0, C.logs(root)
    return root


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_groups_hold_the_process_groups(runs, case):
    dims = case["dims"]
    devices = np.arange(4).reshape(dims)
    axes = ("dp", "pp", "sharding", "sep", "mp")
    for r in range(4):
        got = np.load(os.path.join(runs, f"{case['name']}.r{r}.npz"))
        coord = [int(i) for i in np.argwhere(devices == r)[0]]
        assert got["rank"].tolist() == [r, coord[0], coord[1], coord[2],
                                        coord[3], coord[4]]
        for name, own in [(a, (a,)) for a in axes] + \
                [("check", ("dp", "pp", "sharding"))]:
            mine = [axes.index(a) for a in own]
            sel = tuple(slice(None) if i in mine else coord[i]
                        for i in range(5))
            want = devices[sel].reshape(-1).tolist()
            assert got[f"{name}/ranks"].tolist() == want, (name, r)
            assert int(got[f"{name}/nranks"]) == len(want)
            assert int(got[f"{name}/pg_size"]) == len(want)
            assert got[f"{name}/sum"].tolist() == [float(len(want))]
