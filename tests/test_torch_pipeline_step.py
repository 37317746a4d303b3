"""The port's pipelined train step against the JAX reference's, over
gloo ranks started by the port's launcher (tests/torch_sharded_worker.py)
beside the reference's ``make_sharded_train_step`` on the fake CPU
devices, its compiler off; both start from the reference's weights and
state and take 3 steps on the same global batch.

``make_sharded_train_step`` with pp > 1, through the reference's default
schedule ("1f1b"; the port's "gpipe", set on the built step, against the
reference's "1f1b"): (1, 2, 1), (2, 2, 1) with ZeRO-1, (1, 2, 2) with
Megatron-SP, (2, 2, 2) with MoE at __graft_entry__.py's dryrun config,
and bf16 with fp32 masters. The bars of tests/torch_sharded_common.py:
losses rtol 1e-5 (bf16 1e-3), every rank's gathered parameters bitwise
equal (the leaves the stages replicate included), each leaf's summed
difference within 5e-4 of the reference's summed update (bf16 5%); the
first moments after step 1, (1 - b1) times the gradient, held alike to
the reference's (AdamW's update does not change with the gradient's
scale; m does)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import torch_sharded_common as C

L4 = dict(C.SMALL, n_layers=4)
# __graft_entry__.py's dryrun config at (2, 2, 2): n_layers max(4, 2pp),
# n_heads max(4, mp), hidden 32 n_heads, seq 64, experts max(2, dp), one
# MoE layer, microbatches 2, batch 2 dp M
HYBRID = dict(vocab_size=2048, hidden=128, n_layers=4, n_heads=4,
              seq_len=64, n_experts=2, n_moe_layers=1)


def _case(name, mesh, cfg=L4, **kw):
    """A pp case: its first moments after step 1 compared too."""
    return C.case(name, mesh, cfg=cfg, moment1=True, **kw)


STEPS2 = [
    _case("pp2_1f1b", [1, 2, 1], step=dict(n_microbatches=4)),
    _case("pp2_gpipe", [1, 2, 1], step=dict(n_microbatches=4),
          schedule="gpipe"),
    _case("pp2_master_bf16", [1, 2, 1], cfg=dict(L4, dtype="bfloat16"),
          step=dict(n_microbatches=2)),
]
STEPS4 = [
    _case("dp2_pp2_zero1", [2, 2, 1], step=dict(n_microbatches=2)),
    _case("pp2_mp2_sp", [1, 2, 2], step=dict(n_microbatches=2)),
]
STEPS8 = [_case("hybrid_222_moe", [2, 2, 2], cfg=HYBRID,
                step=dict(n_microbatches=2), batch=8)]
STEPS = STEPS2 + STEPS4 + STEPS8


def _runs(tmp_path_factory, cases, nprocs):
    root = str(tmp_path_factory.mktemp(f"pp_step{nprocs}"))
    return root, C.run_all(root, cases, nprocs=nprocs)


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return _runs(tmp_path_factory, STEPS2, 2)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _runs(tmp_path_factory, STEPS4, 4)


@pytest.fixture(scope="module")
def runs8(tmp_path_factory):
    return _runs(tmp_path_factory, STEPS8, 8)


@pytest.mark.parametrize("case", STEPS, ids=[c["name"] for c in STEPS])
def test_pp_step_matches_the_reference(request, case):
    n = int(np.prod(case["mesh"]))
    root, results = request.getfixturevalue(f"runs{n}")
    C.check_case(case, results[case["name"]], root)
