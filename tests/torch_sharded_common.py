"""Shared by the sharded-step tests: the JAX reference's side of a case
(its ``make_sharded_train_step`` on the 8 fake CPU devices of
tests/conftest.py, its compiler off) and the port's side (gloo ranks
of tests/torch_sharded_worker.py started by the port's launcher).

A case is a dict: ``name``, ``mesh`` (dp, pp, mp), ``cfg`` (GPTConfig
fields, ``dtype`` by name), ``step`` (make_sharded_train_step keywords),
``steps``, ``batch`` and optionally ``quant`` (FLAGS_dist_allreduce_quant)
and ``zero3`` (every parameter through ``shard_array_over(.., "dp")``).
"""

import json
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sharded_worker.py")
BF16 = "::bf16"
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def pack(tree, prefix: str, out: dict) -> dict:
    """Flatten a tree of arrays into npz entries ``prefix/a/b`` (bf16 as
    its 16-bit patterns, the key marked)."""
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            pack(v, key, out)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            out[key + BF16] = a.view(np.uint16)
        else:
            out[key] = a
    return out


def unpack(npz, prefix: str) -> dict:
    """``prefix/...`` entries of a packed npz as {key path: array}, bf16
    as its uint16 patterns."""
    out = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            name = key[len(prefix) + 1:]
            a = npz[key]
            if name.endswith(BF16):
                name, a = name[:-len(BF16)], a.view(np.uint16)
            out[name] = a
    return out


def jcfg(case):
    from paddle_tpu.models.gpt import GPTConfig

    kw = dict(case["cfg"])
    kw["dtype"] = _JDT[kw.pop("dtype", "float32")]
    return GPTConfig(**kw)


def batch(case):
    cfg = case["cfg"]
    rng = np.random.RandomState(case.get("data_seed", 0))
    shape = (case["batch"], cfg["seq_len"])
    return (rng.randint(0, cfg["vocab_size"], size=shape).astype(np.int32),
            rng.randint(0, cfg["vocab_size"], size=shape).astype(np.int32))


def reference_init(case, root: str):
    """Build the reference's step for the case, write its initial state
    and the batch to ``root/<name>.in.npz`` and return (step, params,
    opt_state)."""
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
    from paddle_tpu.distributed.process_mesh import build_mesh
    from paddle_tpu.parallel import train_step as jts

    mesh = build_mesh(tuple(case["mesh"]), ("dp", "pp", "mp"))
    JFLAGS.set("dist_allreduce_quant", bool(case.get("quant")))
    try:
        step, params, opt = jts.make_sharded_train_step(
            jcfg(case), mesh, lr=case["step"].get("lr", 1e-4),
            **{k: v for k, v in case["step"].items() if k != "lr"})
    finally:
        JFLAGS.set("dist_allreduce_quant", False)
    if case.get("zero3"):
        from paddle_tpu.distributed.sharding import shard_array_over

        params = jax.tree.map(
            lambda a: shard_array_over(a, mesh, "dp") if a.ndim else a,
            params)
    tok, lab = batch(case)
    out = pack(params, "params", {})
    pack(opt, "opt", out)
    np.savez(os.path.join(root, f"{case['name']}.in.npz"), tokens=tok,
             labels=lab, **out)
    return step, params, opt, mesh


def reference_run(case, step, params, opt, mesh):
    """The reference's losses and final parameters (numpy)."""
    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS

    tok, lab = batch(case)
    losses = []
    JFLAGS.set("dist_allreduce_quant", bool(case.get("quant")))
    try:
        for _ in range(case["steps"]):
            loss, params, opt = step(params, opt, tok, lab)
            losses.append(float(loss))
    finally:
        JFLAGS.set("dist_allreduce_quant", False)
    return np.asarray(losses), pack(params, "params", {})


def launch(root: str, cases: list, nprocs: int, timeout: float = 240.0):
    """Run the cases in ``nprocs`` gloo ranks through the port's launcher;
    returns its exit code (output under ``root/logs``)."""
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.distributed.launch import launch_procs

    with open(os.path.join(root, "cases.json"), "w") as f:
        json.dump(cases, f)
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    return launch_procs(WORKER, [root], nprocs, env_extra=env,
                        log_dir=os.path.join(root, "logs"), timeout=timeout)


def logs(root: str) -> str:
    d = os.path.join(root, "logs")
    if not os.path.isdir(d):
        return ""
    return "\n".join(open(os.path.join(d, f)).read()[-4000:]
                     for f in sorted(os.listdir(d)))


def port_result(root: str, name: str, rank: int):
    npz = np.load(os.path.join(root, f"{name}.r{rank}.npz"))
    return npz["losses"], unpack(npz, "params")


def run_all(tmp_root: str, cases: list, nprocs: int, timeout: float = 240.0):
    """The port's ranks (in a thread) and the reference's steps (here)
    side by side: {name: (reference losses, reference params, initial
    params)}, after the ranks have finished; asserts they exited 0."""
    import threading

    from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS

    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    try:
        built = {c["name"]: reference_init(c, tmp_root) for c in cases}
        rc = []
        t = threading.Thread(target=lambda: rc.append(
            launch(tmp_root, cases, nprocs, timeout)))
        t.start()
        out = {}
        for c in cases:
            losses, params = reference_run(c, *built.pop(c["name"]))
            init = unpack(np.load(os.path.join(tmp_root,
                                               f"{c['name']}.in.npz")),
                          "params")
            ref = {k[len("params/"):]: v for k, v in params.items()}
            out[c["name"]] = (losses, {k.removesuffix(BF16): (
                v.view(np.uint16) if k.endswith(BF16) else v)
                for k, v in ref.items()}, init)
        t.join()
    finally:
        JFLAGS.set("use_auto_fusion", old)
    assert rc == [0], logs(tmp_root)
    return out


def _f64(a):
    if a.dtype == np.uint16:
        import ml_dtypes

        return a.view(ml_dtypes.bfloat16).astype(np.float64)
    return a.astype(np.float64)


# fp32: the reported losses within rtol 1e-5, and each parameter leaf's
# summed difference to the reference within 5e-4 of the reference's
# summed update (measured at most 1.2e-4, the hybrid case). That is the
# reference's own spread: its (2, 1, 2) run of the hybrid case differs
# from its (1, 1, 1) run by up to 1.5e-4 of the update (proj_w). An
# element-wise bar is not reachable: an element whose fp32 gradient is
# rounding noise (a sum that cancels) takes an AdamW step of about +-lr
# in either package, whatever its sign. bf16 compute with fp32 masters:
# the losses within rtol 1e-3 and 5% of the update (the bars of the
# one-device trajectory test, tests/test_torch_train_step.py).
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
DRIFT = {"float32": 5e-4, "bfloat16": 0.05}


def check_case(case, result, root: str) -> None:
    """Every rank's losses and gathered parameters bitwise equal to rank
    0's; rank 0's against the reference's."""
    ref_losses, ref_params, init = result
    n = int(np.prod(case["mesh"]))
    losses, params = port_result(root, case["name"], 0)
    for r in range(1, n):
        lr_, pr = port_result(root, case["name"], r)
        assert lr_.tobytes() == losses.tobytes(), (r, lr_, losses)
        for k in params:
            assert pr[k].tobytes() == params[k].tobytes(), (r, k)
    dt = case["cfg"].get("dtype", "float32")
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL[dt])
    assert losses[-1] < losses[0]
    assert set(params) == set(ref_params)
    H = case["cfg"]["hidden"]
    for k, want in ref_params.items():
        got, start, want = _f64(params[k]), _f64(init[k]), _f64(want)
        assert got.shape == want.shape, k
        if k.endswith("qkv_b"):
            # the key third's gradient is 0 in exact arithmetic (softmax
            # ignores a shift of a query's scores): both packages step
            # on rounding noise there
            keep = np.ones(3 * H, bool)
            keep[H:2 * H] = False
            got, start, want = got[..., keep], start[..., keep], \
                want[..., keep]
        moved = np.abs(want - start).sum()
        drift = np.abs(got - want).sum() / moved
        assert drift <= DRIFT[dt], (k, drift)


SMALL = dict(vocab_size=128, hidden=64, n_layers=2, n_heads=4, seq_len=16,
             use_flash=False, remat=False)
MOE = dict(SMALL, n_experts=2, n_moe_layers=1)


def case(name, mesh, cfg=SMALL, step=None, batch=8, **kw):
    return dict(name=name, mesh=mesh, cfg=cfg,
                step=dict(dict(lr=1e-3), **(step or {})), steps=3,
                batch=batch, **kw)
