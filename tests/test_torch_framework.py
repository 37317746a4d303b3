"""``paddle_tpu_torch.framework`` (``save`` / ``load``, the mode flags)
against ``paddle_tpu.framework``, on the CPU.

Each package loads the other's files: a small ResNet's state (resnet18's
blocks, one a stage, at 10 classes; the reference's weights carried
across) and its Momentum state after one step. A port file of an fp32
state is byte-equal to the reference's file of the same state, and so
is one with a bf16 leaf, with ``ml_dtypes`` importable and with it
blocked (the card's host has none: the leaf is written as numpy writes
an ``ml_dtypes.bfloat16`` array and read back by its bytes). The
Momentum state files cannot be byte-equal: their per-parameter keys are
each package's own parameter names (separate counters), and the
reference pickles its moments as jax arrays, the port as numpy arrays;
they are loaded across by parameter position
(``optimizer_state_from_jax``). Nested lists, tuples and dicts, plain
values and ``return_numpy`` round-trip in both directions.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)

port.set_device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _small(pkg):
    mods = pkg.vision.models.resnet
    return mods.ResNet(mods.BasicBlock, 18, num_classes=10,
                       layers=[1, 1, 1, 1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' small ResNet after one Momentum step from the same
    weights, and each package's files of their states."""
    d = tmp_path_factory.mktemp("framework")
    ref.seed(0)
    rm = _small(ref)
    pm = _small(port)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    y = np.array([1, 4], np.int64)
    opts = {}
    for pkg, m in ((ref, rm), (port, pm)):
        opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=m.parameters())
        loss = pkg.nn.functional.cross_entropy(m(pkg.to_tensor(x)),
                                               pkg.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        opts[pkg.__name__] = opt
        pkg.save(m.state_dict(), str(d / f"{pkg.__name__}.pdparams"))
        pkg.save(opt.state_dict(), str(d / f"{pkg.__name__}.pdopt"))
    return d, rm, pm, opts["paddle_tpu"], opts["paddle_tpu_torch"]


def test_fp32_state_file_is_byte_equal(tmp_path):
    ref.seed(1)
    rm = _small(ref)
    pm = _small(port)
    pm.set_state_dict(layer_state_from_jax(rm.state_dict(), "cpu"))
    ref.save(rm.state_dict(), str(tmp_path / "r.pdparams"))
    port.save(pm.state_dict(), str(tmp_path / "sub" / "p.pdparams"))
    a = (tmp_path / "r.pdparams").read_bytes()
    b = (tmp_path / "sub" / "p.pdparams").read_bytes()
    assert len(a) == len(b) and a == b


def test_each_loads_the_others_model_state(trained):
    d, rm, pm, _, _ = trained
    from_ref = port.load(str(d / "paddle_tpu.pdparams"))
    from_port = ref.load(str(d / "paddle_tpu_torch.pdparams"))
    rs, ps = rm.state_dict(), pm.state_dict()
    assert list(from_ref) == list(rs) == list(from_port)
    for k in rs:
        assert isinstance(from_ref[k], port.Tensor)
        assert isinstance(from_ref[k], port.Parameter) == isinstance(
            ps[k], port.Parameter)
        assert from_ref[k].stop_gradient == ps[k].stop_gradient
        np.testing.assert_array_equal(from_ref[k].numpy(), rs[k].numpy())
        np.testing.assert_array_equal(from_port[k].numpy(), ps[k].numpy())
    fresh = _small(port)
    fresh.set_state_dict(from_ref)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), rs[k].numpy())


def test_each_loads_the_others_momentum_state(trained):
    from paddle_tpu_torch.utils.convert import optimizer_state_from_jax

    d, rm, pm, r_opt, p_opt = trained
    from_ref = port.load(str(d / "paddle_tpu.pdopt"))
    assert from_ref["step_count"] == 1
    assert all(isinstance(v["velocity"], np.ndarray)
               for v in from_ref["state"].values())
    carried = optimizer_state_from_jax(from_ref, p_opt,
                                       names=r_opt._parameter_names)
    fresh = port.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=pm.parameters())
    fresh.set_state_dict(carried)
    for p, want in zip(pm.parameters(),
                       r_opt.state_dict()["state"].values()):
        np.testing.assert_array_equal(
            fresh._accumulators[id(p)]["velocity"].numpy(),
            np.asarray(want["velocity"]))
    from_port = ref.load(str(d / "paddle_tpu_torch.pdopt"))
    assert from_port["step_count"] == 1
    by_pos = dict(zip(r_opt._parameter_names, from_port["state"].values()))
    r_fresh = ref.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=rm.parameters())
    r_fresh.set_state_dict({"step_count": 1, "state": by_pos})
    for (name, a), p in zip(r_fresh.state_dict()["state"].items(),
                            pm.parameters()):
        np.testing.assert_array_equal(
            np.asarray(a["velocity"]),
            p_opt._accumulators[id(p)]["velocity"].numpy(), err_msg=name)


def _nested(pkg, bf16=False):
    t = pkg.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    if bf16:
        t = t.astype("bfloat16")
    w = pkg.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    return {"a": [t, (w, 3, "x")], "b": {"c": (1.5, None)}, "n": 7,
            "s": np.float32(0.25)}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_nested_round_trip_and_return_numpy(writer, tmp_path):
    w, other = (ref, port) if writer == "ref" else (port, ref)
    path = str(tmp_path / "n.pd")
    w.save(_nested(w), path)
    for pkg in (w, other):
        got = pkg.load(path)
        assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple)
        assert got["a"][1][1:] == (3, "x") and got["b"] == {"c": (1.5, None)}
        assert got["n"] == 7
        assert type(got["s"]) is np.float32 and got["s"] == 0.25
        t, v = got["a"][0], got["a"][1][0]
        assert isinstance(t, pkg.Tensor) and t.stop_gradient
        assert not v.stop_gradient
        np.testing.assert_array_equal(t.numpy(), np.arange(6).reshape(2, 3))
        arrs = pkg.load(path, return_numpy=True)
        assert isinstance(arrs["a"][0], np.ndarray)
        np.testing.assert_array_equal(arrs["a"][1][0], np.ones(3))


@pytest.mark.parametrize("protocol", [2, 4])
def test_bf16_leaf_both_ways(tmp_path, protocol):
    vals = np.array([[1.5, -2.25, 3.0e-3], [65504.0, -0.0, 7.0]],
                    np.float32)
    ref.save({"w": ref.to_tensor(vals).astype("bfloat16"),
              "v": ref.to_tensor(vals[0]).astype("bfloat16")},
             str(tmp_path / "r.pd"), protocol=protocol)
    port.save({"w": port.to_tensor(vals).astype("bfloat16"),
               "v": port.to_tensor(vals[0]).astype("bfloat16")},
              str(tmp_path / "p.pd"), protocol=protocol)
    assert (tmp_path / "r.pd").read_bytes() == (tmp_path / "p.pd").read_bytes()
    want = vals.astype(ml_dtypes.bfloat16)
    got = port.load(str(tmp_path / "r.pd"))["w"]
    assert got._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(got._data.view(torch.int16).numpy(),
                                  want.view(np.int16))
    back = ref.load(str(tmp_path / "p.pd"))["w"]
    assert np.asarray(back._data).dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(back._data).view(np.int16),
                                  want.view(np.int16))
    arr = port.load(str(tmp_path / "r.pd"), return_numpy=True)["w"]
    assert arr.dtype == ml_dtypes.bfloat16


_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
import paddle_tpu_torch as port
port.set_device("cpu")
src, out = sys.argv[1], sys.argv[2]
got = port.load(src)["w"]
assert got._data.dtype == torch.bfloat16
raw = port.load(src, return_numpy=True)["w"]
assert raw.dtype == np.dtype("V2"), raw.dtype
port.save({"w": got}, out)
print(got._data.view(torch.int16).numpy().tolist())
"""


def test_bf16_leaf_without_ml_dtypes(tmp_path):
    """With ``ml_dtypes`` blocked the port reads the reference's bf16
    leaf by its bytes and writes the reference's bytes."""
    vals = np.array([1.5, -2.25, 3.0e-3, 7.0], np.float32)
    src, out = tmp_path / "r.pd", tmp_path / "p.pd"
    ref.save({"w": ref.to_tensor(vals).astype("bfloat16")}, str(src))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(src),
                          str(out)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    bits = vals.astype(ml_dtypes.bfloat16).view(np.int16).tolist()
    assert eval(res.stdout.strip().splitlines()[-1]) == bits
    assert out.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("pkg", [ref.framework, None], ids=["ref", "port"])
def test_mode_flags(pkg):
    fw = pkg or port.framework
    assert fw.in_dynamic_mode() and fw.in_dygraph_mode()
    fw.enable_static()
    try:
        assert not fw.in_dynamic_mode() and not fw.in_dygraph_mode()
    finally:
        fw.disable_static()
    assert fw.in_dynamic_mode()
    if pkg is None:
        assert port.in_dynamic_mode is port.framework.in_dynamic_mode
        assert port.save is port.framework.save
        assert port.load is port.framework.load
        assert port.version.__version__ == ref.version.__version__
