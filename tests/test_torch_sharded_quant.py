"""The port's sharded train step against the JAX reference's at dp 2
(two gloo ranks, tests/torch_sharded_common.py): MoE with the experts
over dp, the int8-wire gradient sync (``FLAGS_dist_allreduce_quant``)
with and without MoE, and the lean moments (bf16 m and v, int8 m), 3
steps from the reference's weights and state."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import pytest

import torch_sharded_common as C

CASES = [
    C.case("dp2_moe", [2, 1, 1], cfg=C.MOE),
    C.case("dp2_quant", [2, 1, 1], quant=True),
    C.case("dp2_quant_moe", [2, 1, 1], cfg=C.MOE, quant=True),
    C.case("dp2_m_bf16", [2, 1, 1],
           step=dict(m_dtype="bfloat16", v_dtype="bfloat16")),
    C.case("dp2_m_int8", [2, 1, 1],
           step=dict(m_dtype="int8", v_dtype="bfloat16")),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_quant"))
    return root, C.run_all(root, CASES, nprocs=2)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_match_the_reference(runs, case):
    root, results = runs
    C.check_case(case, results[case["name"]], root)
