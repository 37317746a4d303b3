"""Shared by the tests of the port's collective API, DataParallel and the
fleet's Layers (tests/test_torch_collective.py,
test_torch_fleet_layers.py, test_torch_data_parallel.py): the inputs
both packages take (numpy, from seeds), and the launch of the port's
gloo ranks (tests/torch_dist_worker.py) beside the reference's side.

A case is a dict with ``name`` and ``kind`` (the worker's function);
a rank writes ``DIR/<name>.r<rank>.npz``. The test writes what the
ranks need from the reference (its initial weights) to
``DIR/<name>.in.npz`` before the launch, and computes the reference's
side while the ranks run.
"""

import json
import os
import sys
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")


def launch(root: str, cases: list, nprocs: int, reference: dict,
           timeout: float = 240.0) -> dict:
    """Start ``nprocs`` gloo ranks on ``cases`` (in a thread) and run
    ``reference``'s functions (name -> no-argument function) meanwhile;
    asserts the ranks exited 0 and returns {name: reference result}."""
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.distributed.launch import launch_procs

    with open(os.path.join(root, "cases.json"), "w") as f:
        json.dump(cases, f)
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    rc = []
    t = threading.Thread(target=lambda: rc.append(launch_procs(
        WORKER, [root], nprocs, env_extra=env,
        log_dir=os.path.join(root, "logs"), timeout=timeout)))
    t.start()
    try:
        out = {name: fn() for name, fn in reference.items()}
    finally:
        t.join()
    assert rc == [0], logs(root)
    return out


def logs(root: str) -> str:
    d = os.path.join(root, "logs")
    if not os.path.isdir(d):
        return ""
    return "\n".join(open(os.path.join(d, f)).read()[-4000:]
                     for f in sorted(os.listdir(d)))


def result(root: str, name: str, rank: int) -> dict:
    npz = np.load(os.path.join(root, f"{name}.r{rank}.npz"))
    return {k: npz[k] for k in npz.files}


def save_inputs(root: str, name: str, arrays: dict) -> None:
    np.savez(os.path.join(root, f"{name}.in.npz"), **arrays)


def load_inputs(root: str, name: str) -> dict:
    npz = np.load(os.path.join(root, f"{name}.in.npz"))
    return {k: npz[k] for k in npz.files}


def spawned_rank(root: str) -> None:
    """A function for ``paddle_tpu_torch.distributed.spawn``: each rank
    writes ``root/spawn.r<rank>.npz`` with the world's size, its rank and
    an all-reduce of (rank + 1) over the world."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist

    r = dist.get_rank()
    t = pt.to_tensor(np.full(3, r + 1.0, np.float32))
    dist.all_reduce(t)
    np.savez(os.path.join(root, f"spawn.r{r}.npz"),
             world=np.array([dist.get_world_size(), r]), sum=t.numpy())


# -- inputs --------------------------------------------------------------------

def tp_arrays(seed: int, shapes: dict) -> dict:
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def bert_batch(vocab: int, B: int, S: int, masked: int, seed: int = 0):
    """ids, token types, MLM labels (``masked`` labelled positions a
    sequence, -100 elsewhere: BERT pretraining data fixes the count a
    sequence, max_predictions_per_seq), NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S))
    tt = (np.arange(S)[None, :] >= rng.randint(S // 4, S, (B, 1))).astype(
        np.int64)
    mlm = np.full((B, S), -100, np.int64)
    for b in range(B):
        pos = rng.choice(S, masked, replace=False)
        mlm[b, pos] = rng.randint(0, vocab, masked)
    return ids, tt, mlm, rng.randint(0, 2, (B,))


def flat_state(prefix: str, state: dict) -> dict:
    return {f"{prefix}/{k}": np.asarray(v) for k, v in state.items()}


def unflat_state(prefix: str, arrays: dict) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


# -- pipelines and MoE ---------------------------------------------------------

def stage_names(parts, pp: int, V: int = 1) -> dict:
    """{layer desc index: sublayer name} of a ``PipelineLayer`` cut at
    ``parts`` into pp x V segments (the reference's ``stage{s}_{k}``)."""
    out = {}
    for s in range(pp):
        k = 0
        for g in range(pp * V):
            if g % pp != s:
                continue
            for i in range(parts[g], parts[g + 1]):
                out[i] = f"stage{s}_{k}"
                k += 1
    return out


def rename_stages(state: dict, src: dict, dst: dict) -> dict:
    """``state``'s keys from one stage naming to another (``stage_names``
    maps of the same desc list); keys of no desc kept."""
    by_src = {v: dst[i] for i, v in src.items()}
    out = {}
    for k, v in state.items():
        head, dot, rest = k.partition(".")
        out[by_src.get(head, head) + dot + rest] = v
    return out


def linear_stack(seed: int, n_layers: int, rows: int):
    """Weights of ``n_layers`` Linear(8, 8) without bias, inputs [rows, 8]
    and class labels (tests/test_zero_bubble.py's model)."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(8, 8).astype(np.float32) * 0.4 for _ in range(n_layers)]
    return ws, rng.randn(rows, 8).astype(np.float32), \
        rng.randint(0, 8, size=(rows,)).astype(np.int64)


def moe_batches(seed: int, batches: int, rows: int, d: int):
    """``batches`` token batches of ``rows`` x ``d`` and their cotangents
    (a sum loss ``(y * cot).sum()``), fp32."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(batches, rows, d).astype(np.float32)
                 for _ in range(2))


def moe_arrays(seed: int, d: int, h: int, E: int) -> dict:
    """An MoELayer's state (Sequential(Linear(d, h), GELU, Linear(h, d))
    experts, a gate over E experts) by the reference's names."""
    rng = np.random.RandomState(seed)
    out = {"gate.gate.weight": rng.randn(d, E).astype(np.float32),
           "gate.gate.bias": (0.1 * rng.randn(E)).astype(np.float32)}
    for e in range(E):
        out[f"experts.{e}.0.weight"] = (rng.randn(d, h) / np.sqrt(d)).astype(
            np.float32)
        out[f"experts.{e}.0.bias"] = (0.1 * rng.randn(h)).astype(np.float32)
        out[f"experts.{e}.2.weight"] = (rng.randn(h, d) / np.sqrt(h)).astype(
            np.float32)
        out[f"experts.{e}.2.bias"] = (0.1 * rng.randn(d)).astype(np.float32)
    return out
