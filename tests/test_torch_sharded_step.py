"""The port's sharded train step against the JAX reference's, over two
gloo ranks started by the port's launcher (tests/torch_sharded_worker.py)
beside the reference's ``make_sharded_train_step`` on the fake CPU
devices, its compiler off; both start from the reference's weights and
state and take 3 steps on the same global batch (bars in
tests/torch_sharded_common.py):

- dp 2 with ZeRO-1 on and off, ZeRO-3 (parameters sharded over dp too);
- mp 2: tensor and sequence parallelism (1, 1, 2), also with MoE, an
  untied head and remat;
- fp32 masters under bf16 compute at dp 2.

(MoE, the int8-wire sync and the lean moments at dp 2 are in
tests/test_torch_sharded_quant.py, the four-rank meshes in
tests/test_torch_sharded_mp.py.)

In one process: the one-device mesh is ``make_train_step`` bit for bit
(dense and MoE), the options the port leaves out are refused, and
``ring_axis`` on the one-device mesh routes attention to K1-sep /
K3-sep; in the two ranks, a pp mesh builds the pipelined step
(tests/test_torch_pipeline.py holds it to the reference)."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_sharded_common as C
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.distributed.process_mesh import build_mesh
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import make_sharded_train_step
from paddle_tpu_torch.parallel import train_step as tts

SMALL, MOE = C.SMALL, C.MOE
CASES = [
    C.case("dp2_zero1", [2, 1, 1]),
    C.case("dp2_no_zero1", [2, 1, 1], step=dict(zero1=False)),
    C.case("dp2_zero3", [2, 1, 1], zero3=True),
    C.case("mp2_sp", [1, 1, 2]),
    # MoE under mp alone (experts whole on each rank, F over mp), an
    # untied head over mp, blocks recomputed in the backward
    C.case("mp2_moe_untied_remat", [1, 1, 2],
           cfg=dict(MOE, tie_embeddings=False, remat=True)),
    C.case("dp2_master_bf16", [2, 1, 1], cfg=dict(SMALL, dtype="bfloat16")),
]
# a (1, 2, 1) mesh's step, built and not run
BUILD = dict(name="build_pp2", kind="build", mesh=[1, 2, 1], cfg=SMALL,
             step=dict(n_microbatches=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded2"))
    return root, C.run_all(root, CASES + [BUILD], nprocs=2,
                           prepare=lambda case, root: lambda: None)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_match_the_reference(runs, case):
    root, results = runs
    C.check_case(case, results[case["name"]], root)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("cfg", [SMALL, MOE], ids=["dense", "moe"])
def test_one_device_mesh_is_make_train_step(cfg):
    """(1, 1, 1) in a plain process (no group): the same state and the
    same three steps as make_train_step, bit for bit."""
    tc = tg.GPTConfig(**cfg, dtype=torch.float32)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    a = make_sharded_train_step(tc, mesh, lr=1e-3, seed=3, device="cpu")
    b = tts.make_train_step(tc, lr=1e-3, seed=3, device="cpu")
    assert a[0].mesh is mesh
    rng = np.random.RandomState(0)
    tok = rng.randint(0, tc.vocab_size, size=(4, tc.seq_len))
    lab = rng.randint(0, tc.vocab_size, size=(4, tc.seq_len))
    (sa, pa, oa), (sb, pb, ob) = a, b
    for _ in range(3):
        la, pa, oa = sa(pa, oa, tok, lab)
        lb, pb, ob = sb(pb, ob, tok, lab)
        assert la.item() == lb.item()
    for x, y in zip(_leaves(pa) + _leaves(oa), _leaves(pb) + _leaves(ob)):
        assert torch.equal(x, y)


def test_later_slices_and_bad_options_are_refused(runs, monkeypatch):
    from paddle_tpu.distributed.autograd_collectives import \
        QUANT_SYNC_PP_REFUSAL as JMSG
    from paddle_tpu_torch.distributed.autograd_collectives import \
        QUANT_SYNC_PP_REFUSAL

    assert QUANT_SYNC_PP_REFUSAL == JMSG
    tc = tg.GPTConfig(**SMALL, dtype=torch.float32)
    # pp > 1 has come: each of the two ranks built the pipelined step with
    # its stage's layer of the blocks
    root, _ = runs
    for r in range(2):
        got = np.load(f"{root}/{BUILD['name']}.r{r}.npz")
        assert str(got["kind"]) == "_ShardedStep"
        assert got["pipe"].tolist() == [2, 2, r]      # stages, M, stage
        assert got["qkv_w_local"].tolist() == [1, SMALL["hidden"],
                                               3 * SMALL["hidden"]]
    with pytest.raises(NotImplementedError, match="abstract.*ROADMAP"):
        make_sharded_train_step(tc, build_mesh((1, 1, 1),
                                               ("dp", "pp", "mp")),
                                abstract=True, device="cpu")
    TFLAGS.set("dist_allreduce_quant", True)
    try:
        with pytest.raises(ValueError) as e:
            make_sharded_train_step(tc, build_mesh((2, 2, 1),
                                                   ("dp", "pp", "mp")),
                                    n_microbatches=2, device="cpu")
        assert str(e.value) == QUANT_SYNC_PP_REFUSAL
    finally:
        TFLAGS.set("dist_allreduce_quant", False)
    with pytest.raises(ValueError, match="v_dtype='int8'"):
        make_sharded_train_step(tc, build_mesh((1, 1, 1),
                                               ("dp", "pp", "mp")),
                                v_dtype="int8", device="cpu")
    # ring_axis has come: over an axis the port does not ring over it is
    # refused by name; on the one-device mesh attention takes the split
    # q, k, v through K1-sep and K3-sep, not the fused-qkv entry
    with pytest.raises(NotImplementedError, match="ring_axis='dp'"):
        make_sharded_train_step(dataclasses.replace(tc, ring_axis="dp"),
                                build_mesh((2, 1, 1), ("dp", "pp", "mp")),
                                device="cpu")
    counts = C.count_flash(monkeypatch)
    # the flash gates' smallest shape: S 128, head dim 64
    flash = dataclasses.replace(tc, use_flash=True, ring_axis="mp",
                                hidden=128, n_heads=2, seq_len=128)
    step, p, o = make_sharded_train_step(
        flash, build_mesh((1, 1, 1), ("dp", "pp", "mp")), device="cpu")
    rng = np.random.RandomState(0)
    tok = rng.randint(0, tc.vocab_size, size=(2, flash.seq_len))
    loss, p, o = step(p, o, tok, tok)
    assert np.isfinite(loss.item())
    assert counts == {"flash_fwd": 0, "flash_fwd_sep": SMALL["n_layers"],
                      "flash_bwd_sep": SMALL["n_layers"]}
    with pytest.raises(NotImplementedError, match="make_sharded_train_step"):
        tg.model_apply({}, torch.zeros((1, 4), dtype=torch.long), tc,
                       sp_constraint=lambda x: x)
