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
