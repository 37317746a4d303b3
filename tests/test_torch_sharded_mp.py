"""The port's sharded train step against the JAX reference's on four
gloo ranks (tests/torch_sharded_common.py), 3 steps from the
reference's weights and state:

- dp 4;
- (2, 1, 2): data, tensor and sequence parallel, with int8 m and bf16 v;
- MoE at (2, 1, 2): the experts over dp, their F columns over mp; with
  ZeRO-3; and at dp 4 with 2 experts (replicated);
- the int8-wire sync at (2, 1, 2);
- the hybrid case of ``__graft_entry__.py::_dryrun_impl`` at (2, 1, 2):
  vocab 2048, hidden 128, 4 layers of 4 heads, T 64, 2 experts in 1 MoE
  layer, fp32, batch 4, flash attention and remat on (the port's flash
  runs its plain version on the CPU)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import pytest

import torch_sharded_common as C

HYBRID = dict(vocab_size=2048, hidden=128, n_layers=4, n_heads=4,
              seq_len=64, n_experts=2, n_moe_layers=1)
CASES = [
    C.case("dp4", [4, 1, 1]),
    C.case("dp2_mp2", [2, 1, 2],
           step=dict(m_dtype="int8", v_dtype="bfloat16")),
    C.case("dp2_mp2_moe", [2, 1, 2], cfg=C.MOE),
    # 2 experts over dp 4: not divisible, so the experts stay whole on
    # every rank (the slots all-reduced instead of reduce-scattered)
    C.case("dp4_moe_replicated", [4, 1, 1], cfg=C.MOE),
    C.case("dp2_mp2_zero3_moe", [2, 1, 2], cfg=C.MOE, zero3=True),
    C.case("dp2_mp2_quant", [2, 1, 2], quant=True),
    C.case("hybrid", [2, 1, 2], cfg=HYBRID, batch=4),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded4"))
    return root, C.run_all(root, CASES, nprocs=4)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_four_ranks_match_the_reference(runs, case):
    root, results = runs
    C.check_case(case, results[case["name"]], root)
