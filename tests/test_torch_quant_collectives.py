"""The port's int8-wire all-reduce (``distributed/autograd_collectives.py
::dist_allreduce_quant``) against the reference's, bit for bit: the port
runs over gloo ranks started by its launcher (tests/torch_sharded_worker
.py), the reference under ``shard_map`` on the fake CPU devices, on the
same inputs; the reference suite's cases (tests/test_quant_collectives.py)
at n 2 and 4: sizes n does not divide (padding), sum and mean, an all-zero
input (exact zeros), the absmax edge (entries of +-1e30), every rank's
result the same; and n 1 returns its input untouched."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import torch_sharded_common as C
from paddle_tpu.distributed.autograd_collectives import \
    dist_allreduce_quant as jquant
from paddle_tpu_torch.distributed.autograd_collectives import \
    dist_allreduce_quant


def _inputs(kind, n, size, seed):
    rng = np.random.RandomState(seed)
    if kind == "zero":
        return np.zeros((n, size), np.float32)
    xs = (rng.randn(n, size) * np.logspace(-3, 1, n)[:, None]).astype(
        np.float32)
    if kind == "edge":
        xs[0, 0] = 1e30
        xs[n - 1, 7] = -1e30
    return xs


CASES = [dict(name=f"q{n}_{kind}_{size}_{'mean' if mean else 'sum'}",
              kind="quant_allreduce", n=n, size=size, mean=mean,
              data=kind, seed=seed)
         for n in (2, 4)
         for kind, size, mean, seed in (("mixed", 257, False, 0),
                                        ("mixed", 4096, True, 1),
                                        ("mixed", 1027, False, 2),
                                        ("zero", 257, False, 3),
                                        ("edge", 1024, False, 4))]
# inputs on which the reference's phase-1 scales (absmax times the
# reciprocal of 127, as XLA compiles absmax / 127 in the jitted region)
# and true divides give other results (phase 2's differ on q2_mixed_1027)
CASES.append(dict(name="q4_mixed_300_recip", kind="quant_allreduce", n=4,
                  size=300, mean=False, data="mixed", seed=1010))


def _reference(xs, mean):
    n = xs.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))

    def body(x):
        return jquant(x[0], "dp", mean=mean, axis_size=n)[None]

    run = jax.shard_map(body, in_specs=JP("dp"), out_specs=JP("dp"),
                        axis_names={"dp"}, check_vma=False)
    with jax.sharding.set_mesh(mesh):
        return np.asarray(jax.jit(run)(jnp.asarray(xs)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("quant"))
    for c in CASES:
        np.savez(os.path.join(root, f"{c['name']}.in.npz"),
                 xs=_inputs(c["data"], c["n"], c["size"], c["seed"]))
    rc = C.launch(root, CASES, nprocs=4, timeout=120)
    assert rc == 0, C.logs(root)
    return root


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_bitwise_equal_to_the_reference(runs, case):
    xs = np.load(os.path.join(runs, f"{case['name']}.in.npz"))["xs"]
    want = _reference(xs, case["mean"])
    for r in range(case["n"]):
        got = np.load(os.path.join(runs, f"{case['name']}.r{r}.npz"))["out"]
        assert got.tobytes() == want[0].tobytes(), (r, np.abs(
            got - want[0]).max())
    if case["data"] == "zero":
        assert not want.any()
    assert np.isfinite(want).all()


def test_one_rank_is_the_identity():
    x = torch.arange(7, dtype=torch.float32)
    assert dist_allreduce_quant(x, None, axis_size=1) is x
    assert dist_allreduce_quant(x) is x          # no group: one rank
