"""Every Layer class of the port's nn/layer norm module, and
``nn.utils``, against the reference's, on the CPU (the harness of
``tests/torch_nn_layer_common.py``: the reference's state carried
across, forward and gradients at fp32 rtol 1e-5). The batch norms run a
training forward, whose running statistics must equal the reference's,
then an eval one. ``SyncBatchNorm`` with a two-rank gloo group equals
the reference's ``BatchNorm`` on the two ranks' batches together:
outputs, input gradients, the ranks' summed weight gradients and the
running statistics.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, close, hold, pair

ROOT = Path(__file__).resolve().parents[1]
X = lambda: _f(2, 4, 6)  # noqa: E731
IMG = lambda: _f(1, 2, 3, 4)  # noqa: E731

NORM = {
    "BatchNorm": ((3,), {}, [_f(4, 3, 5)]),
    "BatchNorm1D": ((3,), {"momentum": 0.8}, [_f(4, 3, 5)]),
    "BatchNorm2D": ((3,), {"epsilon": 1e-3}, [_f(4, 3, 2, 2)]),
    "BatchNorm3D": ((3,), {}, [_f(2, 3, 2, 2, 2)]),
    "SyncBatchNorm": ((3,), {}, [_f(4, 3, 2, 2)]),
    "LayerNorm": (([3, 6],), {"epsilon": 1e-12}, [_f(2, 3, 6)]),
    "RMSNorm": ((6,), {}, [X()]),
    "GroupNorm": ((2, 4), {}, [X()]),
    "InstanceNorm1D": ((4,), {}, [X()]),
    "InstanceNorm2D": ((2,), {}, [IMG()]),
    "InstanceNorm3D": ((2,), {}, [_f(1, 2, 2, 3, 3)]),
    "LocalResponseNorm": ((3,), {}, [_f(2, 5, 3, 3)]),
    "SpectralNorm": (([4, 3],), {"power_iters": 2}, [_f(4, 3)]),
}


def test_every_norm_class_has_a_case():
    names = set(ref.nn.layer.norm.__all__)
    assert set(port.nn.layer.norm.__all__) == names
    assert set(NORM) == names


@pytest.mark.parametrize("name", sorted(NORM))
def test_norm_layer_against_reference(name):
    args, kwargs, inputs = NORM[name]
    rl, pl = pair(name, *args, **kwargs)
    train = "BatchNorm" in name
    hold(rl, pl, inputs, train=train, what=name)
    if train:
        for k, v in rl.state_dict().items():
            close(pl.state_dict()[k].numpy(), v.numpy(), f"{name} {k}")
        hold(rl, pl, inputs, train=False, what=name + " eval")


@pytest.mark.parametrize("fn", ["clip_grad_norm_", "clip_grad_value_"])
def test_nn_utils_clips(fn):
    grads = [_f(3, 4), _f(5, seed=1) * 3]
    outs = []
    for pkg in (ref, port):
        ps = [pkg.to_tensor(np.zeros_like(g), stop_gradient=False)
              for g in grads]
        loss = sum((p * pkg.to_tensor(g)).sum() for p, g in zip(ps, grads))
        loss.backward()
        arg = 0.5 if fn == "clip_grad_value_" else 1.5
        res = getattr(pkg.nn.utils, fn)(ps, arg)
        outs.append(([p.grad.numpy() for p in ps], res))
    (rg, rr), (pg, pr) = outs
    for a, b in zip(pg, rg):
        close(a, b, fn)
    if fn == "clip_grad_norm_":
        close(pr.numpy(), rr.numpy(), "total norm")


def test_nn_utils_vectors_and_reparameterisations():
    ws = [_f(3, 4), _f(4, seed=1)]
    rv = ref.nn.utils.parameters_to_vector([ref.to_tensor(w) for w in ws])
    pv = port.nn.utils.parameters_to_vector([port.to_tensor(w) for w in ws])
    close(pv.numpy(), rv.numpy(), "parameters_to_vector")
    pps = [port.Parameter(np.zeros_like(w)) for w in ws]
    port.nn.utils.vector_to_parameters(pv, pps)
    for p, w in zip(pps, ws):
        close(p.numpy(), w, "vector_to_parameters")
    for dim in (0, None):
        rl, pl = pair("Linear", 4, 3)
        ref.nn.utils.weight_norm(rl, dim=dim)
        port.nn.utils.weight_norm(pl, dim=dim)
        assert list(pl.state_dict()) == list(rl.state_dict())
        hold(rl, pl, [_f(2, 4)], what=f"weight_norm dim={dim}")
        ref.nn.utils.remove_weight_norm(rl)
        port.nn.utils.remove_weight_norm(pl)
        close(pl.weight.numpy(), rl.weight.numpy(), "remove_weight_norm")
    rl, pl = pair("Linear", 4, 3)
    ref.nn.utils.spectral_norm(rl, n_power_iterations=2)
    port.nn.utils.spectral_norm(pl, n_power_iterations=2)
    assert list(pl.state_dict()) == list(rl.state_dict())
    pl.set_state_dict(layer_state_from_jax(rl.state_dict(), "cpu"))
    hold(rl, pl, [_f(2, 4)], what="spectral_norm")


_SYNC_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    import paddle_tpu_torch as pt

    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    pt.set_device("cpu")
    data = np.load(path)
    bn = pt.nn.SyncBatchNorm(3)
    bn.set_state_dict({"weight": pt.to_tensor(data["w"]),
                       "bias": pt.to_tensor(data["b"])})
    x = pt.to_tensor(data["x"][rank * 4:(rank + 1) * 4], stop_gradient=False)
    y = bn(x)
    (y * pt.to_tensor(data["cot"][rank * 4:(rank + 1) * 4])).sum().backward()
    np.savez(path + f".{rank}.npz", y=y.numpy(), dx=x.grad.numpy(),
             dw=bn.weight.grad.numpy(), mean=bn._mean.numpy(),
             var=bn._variance.numpy())
    dist.destroy_process_group()
""")


def test_sync_batch_norm_over_two_gloo_ranks(tmp_path):
    """Two ranks of 4 samples each: the outputs, the input gradients,
    the summed weight gradients and the running statistics equal the
    reference's BatchNorm over all 8."""
    import socket

    x, cot = _f(8, 3, 2, 2), _f(8, 3, 2, 2, seed=1)
    w, b = _f(3, seed=2), _f(3, seed=3)
    path = str(tmp_path / "in.npz")
    np.savez(path, x=x, cot=cot, w=w, b=b)
    script = tmp_path / "worker.py"
    script.write_text(_SYNC_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               str(free), path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    got = [np.load(path + f".{r}.npz") for r in range(2)]

    bn = ref.nn.BatchNorm2D(3)
    bn.set_state_dict({"weight": ref.to_tensor(w), "bias": ref.to_tensor(b)})
    bn.train()
    xr = ref.to_tensor(x, stop_gradient=False)
    y = bn(xr)
    (y * ref.to_tensor(cot)).sum().backward()
    close(np.concatenate([g["y"] for g in got]), y.numpy(), "y")
    close(np.concatenate([g["dx"] for g in got]), xr.grad.numpy(), "dx")
    close(got[0]["dw"] + got[1]["dw"], bn.weight.grad.numpy(), "dweight")
    for g in got:
        close(g["mean"], bn._mean.numpy(), "running mean")
        close(g["var"], bn._variance.numpy(), "running variance")
