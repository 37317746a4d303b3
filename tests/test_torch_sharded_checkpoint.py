"""Checkpoints of sharded training state, across packages: the
reference's fp32 AdamW state of ``make_sharded_train_step`` (one step
taken, so that every moment is nonzero) at dp 2 with ZeRO-1, at mp 2
(the fused qkv columns in the port's head-aligned order) and at pp 2
(each rank its stage's layers of the blocks, carried in by the
converter and gathered back by ``gather_tree``) is saved by
the reference (one chunk a shard) and by the port's two gloo ranks (each
its blocks at their global offsets; the first replica only; a rank's
qkv block as three chunks, q, k and v), and each package loads what the
other wrote, bitwise. bf16 stays out: the reference cannot read a bf16
chunk (ROADMAP.md, Queue 3, defect A)."""

import json
import os

import numpy as np
import pytest

import jax

import torch_sharded_common as C
from paddle_tpu import to_tensor
from paddle_tpu.distributed import checkpoint as jck

CFG = dict(C.SMALL)
CASES = [dict(name=f"ckpt_{tag}", kind="checkpoint", mesh=mesh, cfg=CFG,
              step=dict(lr=1e-3), steps=1, batch=8)
         for tag, mesh in (("dp2_zero1", [2, 1, 1]), ("mp2", [1, 1, 2]),
                           ("pp2", [1, 2, 1]))]


def _targets(tree):
    if isinstance(tree, dict):
        return {k: _targets(v) for k, v in tree.items()}
    return to_tensor(np.zeros_like(np.asarray(tree)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v.numpy() if hasattr(v, "numpy") else v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS

    root = str(tmp_path_factory.mktemp("ckpt"))
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    want = {}
    try:
        for c in CASES:
            step, p, o, mesh = C.reference_init(c, root)
            tok, lab = C.batch(c)
            _, p, o = step(p, o, tok, lab)
            np.savez(os.path.join(root, f"{c['name']}.in.npz"),
                     **C.pack(p, "params", C.pack(o, "opt", {})))
            jck.save_state_dict({"params": p, "opt": o},
                                os.path.join(root, c["name"], "jax"))
            want[c["name"]] = _flat({"params": jax.tree.map(np.asarray, p),
                                     "opt": jax.tree.map(np.asarray, o)})
    finally:
        JFLAGS.set("use_auto_fusion", old)
    rc = C.launch(root, CASES, nprocs=2, timeout=120)
    assert rc == 0, C.logs(root)
    return root, want


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_the_port_loads_the_references_sharded_checkpoint(runs, case):
    root, want = runs
    for r in range(2):
        npz = np.load(os.path.join(root, f"{case['name']}.r{r}.npz"))
        got = {**{f"params/{k}": v for k, v in C.unpack(npz,
                                                        "params").items()},
               **{f"opt/{k}": v for k, v in C.unpack(npz, "opt").items()}}
        assert set(got) == set(want[case["name"]])
        for k, v in want[case["name"]].items():
            assert got[k].dtype == v.dtype and \
                got[k].tobytes() == v.tobytes(), (r, k)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_the_reference_loads_the_ports_sharded_checkpoint(runs, case):
    root, want = runs
    path = os.path.join(root, case["name"], "port")
    assert jck.verify_checkpoint(path) == (True, [])
    tree = {}
    for k, v in want[case["name"]].items():
        d = tree
        for part in k.split("/")[:-1]:
            d = d.setdefault(part, {})
        d[k.split("/")[-1]] = v
    target = _targets(tree)
    jck.load_state_dict(target, path)
    got = _flat(target)
    for k, v in want[case["name"]].items():
        assert got[k].tobytes() == v.tobytes(), k
    # each rank wrote its blocks: over mp, a rank's qkv_w block as its
    # q, k and v columns, at their offsets in the reference's order
    metas = [json.load(open(os.path.join(path, f"metadata_{r}.json")))
             for r in range(2)]
    qkv = [m["state_dict_metadata"]["params.blocks.qkv_w"]["chunks"]
           for m in metas if "params.blocks.qkv_w" in
           m["state_dict_metadata"]]
    H = CFG["hidden"]
    if case["mesh"][2] == 2:
        offs = sorted(ch["global_offset"][-1] for chs in qkv for ch in chs)
        assert offs == [0, H // 2, H, 3 * H // 2, 2 * H, 5 * H // 2]
    else:
        # one chunk a stage of the pipeline
        assert [len(chs) for chs in qkv] == [1] * case["mesh"][1]
