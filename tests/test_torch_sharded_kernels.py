"""Where the sharded train step runs the training kernels. The sharded
forward (``models/gpt.py::sharded_loss_fn``) is not traced by the
fusion compiler, so it places K6 (residual + LayerNorm), K7 (bias +
gelu) and K4/K5 (the cross-entropy) itself. On the CPU the wrappers run
their plain versions; the cases count the wrapper calls
(tests/torch_sharded_worker.py ``counting_kernels``), with the
cross-entropy gate let through on the CPU. Per rank and step: K6 at
2L + M + 1 LayerNorms, K7 at L gelus, K4 and K5 once.

- In one process: the step's own class on the one-rank mesh (every
  collective the identity) against ``make_train_step``, whose compiler
  places the same kernels: losses rtol 1e-5, each leaf within the
  sharded tests' bar (tests/torch_sharded_common.py).
- Over two gloo ranks, against the reference as the other sharded
  tests: dp 2 with the experts over dp, and mp 2 with SP and the
  vocab-parallel loss through K4/K5 on each rank's vocab slab; pp 2
  with M microbatches, dense and MoE, where each stage runs its Ls
  blocks twice a microbatch (the forward, then the backward's replay):
  K6 4 Ls M and K7 2 Ls M a rank, and the last stage's tail once a
  microbatch (dense: K6, K4, K5 M times) or, with MoE, once a step (K6
  at the MoE and final LayerNorms, K4 and K5 once); each rank sends M
  tensors a step to its neighbour (activations on, cotangents back).

The config is the smallest whose rows pass the kernels' gates (hidden
128, 256-row multiples at every LayerNorm and gelu)."""

import numpy as np
import pytest
import torch

import torch_sharded_common as C
import torch_sharded_worker as W
from paddle_tpu_torch.distributed.process_mesh import build_mesh
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import train_step as tts

KCFG = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=4, seq_len=256,
            n_experts=2, n_moe_layers=1, use_flash=False, remat=False)
CASES = [
    C.case("dp2_moe_kernels", [2, 1, 1], cfg=KCFG, batch=4, count=True,
           ce_kernels=True),
    C.case("mp2_moe_kernels", [1, 1, 2], cfg=KCFG, batch=4, count=True,
           ce_kernels=True),
    C.case("pp2_moe_kernels", [1, 2, 1], cfg=KCFG, batch=4, count=True,
           ce_kernels=True, step=dict(n_microbatches=2), moment1=True),
    C.case("pp2_kernels", [1, 2, 1],
           cfg=dict(KCFG, n_experts=0, n_moe_layers=0), batch=4, count=True,
           ce_kernels=True, step=dict(n_microbatches=2), moment1=True),
]


def _want(cfg: dict, steps: int, stage: int = 0, n_stages: int = 1,
          micro: int = 1) -> dict:
    L, M = cfg["n_layers"], cfg["n_moe_layers"]
    if n_stages == 1:
        return {"fused_norm_epilogue": (2 * L + M + 1) * steps,
                "fused_bias_act": L * steps, "fused_ce_fwd": steps,
                "fused_ce_bwd": steps}
    Ls = L // n_stages
    tails = (1 if M else micro) if stage == n_stages - 1 else 0
    return {"fused_norm_epilogue": (4 * Ls * micro + tails * (M + 1))
            * steps, "fused_bias_act": 2 * Ls * micro * steps,
            "fused_ce_fwd": tails * steps, "fused_ce_bwd": tails * steps,
            "ppermute_sends": micro * steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_kernels"))
    return root, C.run_all(root, CASES, nprocs=2)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_place_the_kernels(runs, case):
    root, results = runs
    C.check_case(case, results[case["name"]], root)
    pp = case["mesh"][1]
    for rank in range(2):
        npz = np.load(f"{root}/{case['name']}.r{rank}.npz")
        got = {k[len("count/"):]: int(npz[k]) for k in npz.files
               if k.startswith("count/")}
        if pp == 1:
            assert got.pop("ppermute_sends") == 0
        assert got == _want(case["cfg"], case["steps"], rank, pp,
                            case["step"].get("n_microbatches", 1)), \
            (rank, got)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, pre + (k,))]
    return [(pre, tree)]


def test_one_rank_sharded_step_matches_make_train_step():
    cfg = tg.GPTConfig(**KCFG, dtype=torch.float32)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, size=(4, cfg.seq_len))
    lab = rng.randint(0, cfg.vocab_size, size=(4, cfg.seq_len))
    runs = {}
    for name in ("make_train_step", "sharded"):
        step, params, opt = tts.make_train_step(cfg, lr=1e-3, seed=3,
                                                device="cpu")
        start = {p: t.clone() for p, t in _paths(params)}
        if name == "sharded":
            step = tts._ShardedStep(cfg, mesh, 1e-3, False,
                                    torch.device("cpu"), 3)
        case = dict(count=name == "sharded", ce_kernels=True)
        losses = []
        with W.counting_kernels(case) as counts:
            for _ in range(3):
                loss, params, opt = step(params, opt, tok, lab)
                losses.append(loss.item())
        runs[name] = losses, dict(_paths(params)), counts
    (lo, po, _), (ls, ps, counts) = runs["make_train_step"], runs["sharded"]
    assert counts == dict(_want(KCFG, 3), ppermute_sends=0)
    np.testing.assert_allclose(ls, lo, rtol=C.LOSS_RTOL["float32"])
    H = cfg.hidden
    for path, want in po.items():
        got, want, s = (C._f64(t.detach().numpy())
                        for t in (ps[path], want, start[path]))
        if path[-1] == "qkv_b":
            # the key third's gradient is 0 in exact arithmetic (see
            # torch_sharded_common.check_case)
            keep = np.ones(3 * H, bool)
            keep[H:2 * H] = False
            got, want, s = got[..., keep], want[..., keep], s[..., keep]
        drift = np.abs(got - want).sum() / np.abs(want - s).sum()
        assert drift <= C.DRIFT["float32"], (path, drift)
