"""The port's format-v2 checkpoints against the JAX package's on the CPU.

- The same fp32 state written by both packages: metadata and manifest
  JSON equal (text and parsed), every npz member's bytes equal.
- Each package loads what the other wrote, bitwise: fp32 both ways; a
  bf16 chunk the reference wrote (``'<V2'`` bytes named ``bfloat16``) and
  a state's bf16 leaves read by the port. The reference's own loader
  fails on such a chunk (it assigns the ``V2`` bytes into a bfloat16
  buffer): a reference defect the port does not reproduce.
- An array sharded over the 8 virtual CPU devices (tests/conftest.py):
  the reference writes 8 chunks, the port assembles them on load.
- The reference's integrity cases (tests/test_chaos.py) on the port's
  writer: crc corruption, each torn kind, rotation and ``LATEST``, v1
  legacy, async failures surfacing, npz handles closed, an unset root; an
  async save holds the state as it was when the save was called; a tuple
  leaf is refused as the reference's writer refuses it.
- Cross-package resume of a tiny GPT: JAX trains 2 steps and saves
  ``{"params", "opt"}``, the port loads it bitwise and takes step 3,
  equal to JAX's step 3 (fp32 loss rtol 1e-5, the step counter and the
  loaded AdamW state bit-equal); and the reverse, the port training and
  JAX resuming. A bf16 training state (bf16 weights and moments, fp32
  masters) that JAX wrote resumes in the port bitwise, where the
  reference cannot resume it.
"""

import json
import os
import threading
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import paddle_tpu as pt
from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.process_mesh import build_mesh
from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import train_step as jts
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import resilient_step as trs
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils.convert import opt_state_from_jax, params_from_jax


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jchaos.disarm()
    tchaos.disarm()


def _state_np(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(5, 7).astype(np.float32),
            "layer": {"b": rng.randn(7).astype(np.float32),
                      "e": rng.randn(3, 2, 4).astype(np.float32)},
            "t": np.array(3, np.int32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax_targets(tree):
    """The reference's load targets: its Tensors, zero-filled."""
    if isinstance(tree, dict):
        return {k: _jax_targets(v) for k, v in tree.items()}
    return pt.to_tensor(np.zeros_like(np.asarray(tree)))


def _flat_np(tree) -> dict:
    out = {}
    for k, v in tck.flatten_state_dict(tree).items():
        if isinstance(v, JTensor):
            v = v.numpy()
        elif isinstance(v, torch.Tensor):
            v = v.detach()
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16
                 else v).numpy()
        out[k] = np.asarray(v)
    return out


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


# -- the format -------------------------------------------------------------

def test_fp32_files_equal_the_reference(tmp_path):
    """Metadata and manifest JSON equal (text and parsed); every npz
    member (npy header and array bytes) equal."""
    js = jax.tree.map(jnp.asarray, _state_np())
    jck.save_state_dict(js, str(tmp_path / "j"))
    # the same dict order (JAX's tree map sorts keys): the JSON text keeps it
    tck.save_state_dict(_torch_tree(jax.tree.map(np.asarray, js)),
                        str(tmp_path / "t"))
    for name in ("metadata_0.json", "manifest_0.json"):
        jt, tt = _read(tmp_path / "j" / name), _read(tmp_path / "t" / name)
        assert tt == jt, name
        assert json.loads(tt) == json.loads(jt)
    assert _members(tmp_path / "t" / "0_0.npz") == \
        _members(tmp_path / "j" / "0_0.npz")
    meta = json.loads(_read(tmp_path / "t" / "metadata_0.json"))
    assert meta["format"] == 2
    assert meta["state_dict_metadata"]["t"]["chunks"][0]["local_shape"] == []


def test_fp32_loads_bitwise_both_ways(tmp_path):
    s = _state_np(1)
    jck.save_state_dict(jax.tree.map(jnp.asarray, s), str(tmp_path / "j"))
    target = _torch_tree(jax.tree.map(np.zeros_like, s))
    tck.load_state_dict(target, str(tmp_path / "j"))
    for k, v in _flat_np(target).items():
        assert v.dtype == _flat_np(s)[k].dtype
        assert v.tobytes() == _flat_np(s)[k].tobytes(), k
    tck.save_state_dict(_torch_tree(s), str(tmp_path / "t"))
    jt = _jax_targets(s)
    jck.load_state_dict(jt, str(tmp_path / "t"))
    for k, v in _flat_np(jt).items():
        assert v.tobytes() == _flat_np(s)[k].tobytes(), k


def test_bf16_chunks_read_by_their_bytes(tmp_path):
    """A bf16 chunk the reference wrote (``'<V2'``, named bfloat16) reads
    bitwise into a bf16 target and casts into an fp32 one; the port writes
    the same member bytes and metadata. The reference's own loader fails
    on that chunk, and its walk-back finds no checkpoint."""
    rng = np.random.RandomState(2)
    w = jnp.asarray(rng.randn(6, 5).astype(np.float32)).astype(jnp.bfloat16)
    m = jnp.asarray(rng.randn(4).astype(np.float32))
    bits = np.asarray(w).view(np.uint16)
    root = str(tmp_path / "j")
    jck.save_checkpoint({"w": w, "m": m}, root, 1)
    d = jck.step_dir(root, 1)
    with zipfile.ZipFile(os.path.join(d, "0_0.npz")) as z:
        assert b"'descr': '<V2'" in z.read("w#0.npy")[:80]
    meta = json.loads(_read(os.path.join(d, "metadata_0.json")))
    assert meta["state_dict_metadata"]["w"]["dtype"] == "bfloat16"
    tw = torch.zeros(6, 5, dtype=torch.bfloat16)
    tm = torch.zeros(4)
    assert tck.load_latest_valid({"w": tw, "m": tm}, root) == 1
    assert np.array_equal(tw.view(torch.int16).numpy().view(np.uint16), bits)
    assert tm.numpy().tobytes() == np.asarray(m).tobytes()
    t32 = torch.zeros(6, 5)
    tck.load_state_dict({"w": t32, "m": tm}, d)
    assert torch.equal(t32, tw.float())
    tck.save_state_dict({"w": tw, "m": tm}, str(tmp_path / "t"))
    assert _members(tmp_path / "t" / "0_0.npz") == \
        _members(os.path.join(d, "0_0.npz"))
    assert _read(tmp_path / "t" / "metadata_0.json") == \
        _read(os.path.join(d, "metadata_0.json"))
    # the reference defect (ROADMAP Queue 3): its loader cannot read it
    jt = {"w": pt.to_tensor(np.zeros((6, 5), np.float32)).astype("bfloat16"),
          "m": pt.to_tensor(np.zeros(4, np.float32))}
    with pytest.raises(ValueError):
        jck.load_state_dict(jt, d)
    assert jck.load_latest_valid(jt, root) is None


def test_sharded_reference_checkpoint_reshards_on_load(tmp_path):
    """An array sharded over the 8 virtual CPU devices: the reference
    writes one chunk a shard, the port assembles the whole on load."""
    devs = jax.devices()
    assert len(devs) == 8
    mesh = Mesh(np.array(devs).reshape(4, 2), ("a", "b"))
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) * 0.5
    y = np.arange(16, dtype=np.float32)
    xs = jax.device_put(x, NamedSharding(mesh, PartitionSpec("a", "b")))
    ys = jax.device_put(y, NamedSharding(mesh, PartitionSpec(("a", "b"))))
    jck.save_state_dict({"x": xs, "y": ys}, str(tmp_path / "j"))
    meta = json.loads(_read(tmp_path / "j" / "metadata_0.json"))
    assert len(meta["state_dict_metadata"]["x"]["chunks"]) == 8
    assert len(meta["state_dict_metadata"]["y"]["chunks"]) == 8
    tx, ty = torch.zeros(8, 6), torch.zeros(16)
    assert tck.verify_checkpoint(str(tmp_path / "j")) == (True, [])
    tck.load_state_dict({"x": tx, "y": ty}, str(tmp_path / "j"))
    assert tx.numpy().tobytes() == x.tobytes()
    assert ty.numpy().tobytes() == y.tobytes()


def test_tuple_leaf_refused_as_the_reference_refuses_it(tmp_path):
    """An int8 moment held as a ``(q, scales)`` tuple is one leaf to the
    flattening; the reference's writer fails on it inside np.asarray,
    the port refuses it with a message."""
    q = np.ones((4, 4), np.int8)
    sc = np.ones(4, np.float32)
    with pytest.raises(ValueError, match="inhomogeneous"):
        jck.save_state_dict({"m": (jnp.asarray(q), jnp.asarray(sc))},
                            str(tmp_path / "j"))
    with pytest.raises(ValueError, match="tuple leaf"):
        tck.save_state_dict({"m": (torch.from_numpy(q),
                                   torch.from_numpy(sc))},
                            str(tmp_path / "t"))


# -- integrity (the reference's tests/test_chaos.py cases) ------------------

def _save_steps(root, upto, start=1):
    for s in range(start, upto + 1):
        tck.save_checkpoint({"w": torch.full((4, 4), float(s))}, root, s,
                            keep_last_k=4)


def test_checkpoint_rotation_and_latest_pointer(tmp_path):
    root = str(tmp_path / "ck")
    t = torch.ones(2, 2)
    for s in range(1, 6):
        tck.save_checkpoint({"w": t}, root, s, keep_last_k=3)
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004", "step_00000005"]
    assert tck.latest_step(root) == 5
    assert jck.latest_step(root) == 5
    assert tck.step_dir(root, 7) == jck.step_dir(root, 7)


def test_crc_detects_corrupt_chunk(tmp_path):
    """Bytes changed inside a valid zip: only the recorded crc can tell."""
    d = str(tmp_path / "ck")
    tck.save_state_dict({"w": torch.ones(4, 4)}, d)
    with open(os.path.join(d, "0_0.npz"), "wb") as f:
        np.savez(f, **{"w#0": np.full((4, 4), 7.0, np.float32)})
    ok, problems = tck.verify_checkpoint(d)
    assert not ok and any("crc" in p for p in problems), problems
    with pytest.raises(tck.CheckpointCorruption):
        tck.load_state_dict({"w": torch.zeros(4, 4)}, d)
    assert jck.verify_checkpoint(d)[0] is False


@pytest.mark.parametrize("kind", ["torn", "torn_manifest", "missing_meta",
                                  "corrupt"])
def test_torn_save_detected_and_walked_back(tmp_path, kind):
    """Each torn-save shape is flagged by both packages' verification and
    skipped by the port's walk-back, which resumes from the last good
    step."""
    root = str(tmp_path / "ck")
    _save_steps(root, 3)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("checkpoint.save", kind, at=0))
    tck.save_checkpoint({"w": torch.full((4, 4), 99.0)}, root, 4,
                        keep_last_k=4)
    tchaos.disarm()
    d4 = tck.step_dir(root, 4)
    assert not tck.verify_checkpoint(d4)[0], kind
    assert not jck.verify_checkpoint(d4)[0], kind
    target = torch.zeros(4, 4)
    assert tck.load_latest_valid({"w": target}, root) == 3
    assert torch.equal(target, torch.full((4, 4), 3.0))


def test_load_latest_valid_none_when_empty_or_unset(tmp_path):
    t = torch.zeros(2)
    assert tck.load_latest_valid({"w": t}, str(tmp_path / "nope")) is None
    for root in (None, ""):
        assert tck.latest_step(root) is None
        assert tck.load_latest_valid({"w": t}, root) is None


def test_legacy_v1_checkpoint_still_loads(tmp_path):
    d = str(tmp_path / "ck")
    tck.save_state_dict({"w": torch.full((3, 3), 5.0)}, d)
    os.remove(os.path.join(d, "manifest_0.json"))
    mp = os.path.join(d, "metadata_0.json")
    with open(mp) as f:
        meta = json.load(f)
    meta.pop("format")
    for info in meta["state_dict_metadata"].values():
        for ch in info["chunks"]:
            ch.pop("crc32")
    with open(mp, "w") as f:
        json.dump(meta, f)
    ok, problems = tck.verify_checkpoint(d)
    assert ok, problems
    target = torch.zeros(3, 3)
    tck.load_state_dict({"w": target}, d)
    assert torch.equal(target, torch.full((3, 3), 5.0))


def test_async_save_failure_surfaces(tmp_path):
    """A failed background write re-raises on join() and, with nobody
    joining, on the next save."""
    t = torch.ones(2, 2)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("checkpoint.save", "raise",
                                            at=0))
    th = tck.save_state_dict({"w": t}, str(tmp_path / "a"), async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        th.join()
    tck.save_state_dict({"w": t}, str(tmp_path / "b"))
    tchaos.arm(tchaos.FaultPlan(seed=0).add("checkpoint.save", "raise",
                                            at=0))
    th2 = tck.save_state_dict({"w": t}, str(tmp_path / "c"),
                              async_save=True)
    threading.Thread.join(th2)
    with pytest.raises(RuntimeError, match="previous async checkpoint"):
        tck.save_state_dict({"w": t}, str(tmp_path / "d"))
    tck.save_state_dict({"w": t}, str(tmp_path / "e"))


def test_async_save_holds_the_state_at_the_call(tmp_path):
    """The port's step writes its state in place: an async save must hold
    the bytes the state had when the save was called, whatever the
    caller writes while the file is being written."""
    w = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    b = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
    want_w, want_b = w.clone(), b.clone()
    d = str(tmp_path / "ck")
    th = tck.save_state_dict({"w": w, "b": b}, d, async_save=True)
    w.add_(1.0)
    b.mul_(2.0)
    th.join()
    got_w, got_b = torch.zeros_like(w), torch.zeros_like(b)
    tck.load_state_dict({"w": got_w, "b": got_b}, d)
    assert torch.equal(got_w, want_w) and torch.equal(got_b, want_b)


def test_load_closes_npz_handles(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    t = torch.ones(2, 2)
    tck.save_state_dict({"w": t}, d)
    opened = []
    real_load = np.load

    def tracking_load(*a, **k):
        f = real_load(*a, **k)
        opened.append(f)
        return f

    monkeypatch.setattr(np, "load", tracking_load)
    tck.load_state_dict({"w": t}, d)
    assert opened
    for f in opened:
        assert f.zip is None, "NpzFile left open after load"


def test_load_refuses_a_shape_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    tck.save_state_dict({"w": torch.ones(4)}, d)
    with pytest.raises(ValueError, match="shape"):
        tck.load_state_dict({"w": torch.zeros(2, 2)}, d)


# -- cross-package resume ---------------------------------------------------

SMALL = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=2, seq_len=32)
LR = 1e-3


@pytest.fixture
def no_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _batch(step: int):
    rng = np.random.RandomState(100 + step)
    tok = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    lab = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["seq_len"]))
    return tok, lab


def _jax_run(steps: int):
    """The uninterrupted JAX run: (losses, state after each step, as
    numpy), fp32 moments."""
    jc = jg.GPTConfig(**SMALL, dtype=jnp.float32)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    jstep, jp, js = jts.make_sharded_train_step(jc, mesh, lr=LR,
                                                zero1=False)
    losses, states = [], [jax.tree.map(np.array, {"params": jp,
                                                  "opt": js})]
    for s in range(steps):
        loss, jp, js = jstep(jp, js, *_batch(s))
        losses.append(float(loss))
        states.append(jax.tree.map(np.array, {"params": jp, "opt": js}))
    return losses, states, jstep


def _port_state_from(np_state):
    return {"params": params_from_jax(np_state["params"], "cpu"),
            "opt": opt_state_from_jax(np_state["opt"], "cpu")}


def test_resume_jax_checkpoint_in_the_port(tmp_path, no_auto_fusion):
    """JAX trains 2 steps and saves {params, opt}; the port's resilient
    loop resumes it bitwise and takes step 3, equal to JAX's step 3."""
    losses, states, _ = _jax_run(3)
    root = str(tmp_path / "ck")
    jck.save_checkpoint(jax.tree.map(jnp.asarray, states[2]), root, 2)
    tc = tg.GPTConfig(**SMALL, dtype=torch.float32)
    loop = trs.make_resilient_loop(
        tc, root, step_kwargs=dict(lr=LR, device="cpu", seed=7),
        save_every=100, keep_last_k=3, step_timeout=60.0)
    assert loop.donated_step
    assert loop.resume() == 2 and loop.step == 2
    for k, v in _flat_np(loop.state).items():
        want = _flat_np(_port_state_from(states[2]))[k]
        assert v.dtype == want.dtype and v.tobytes() == want.tobytes(), k
    loss3 = loop.run_step(_batch(2))
    np.testing.assert_allclose(loss3, losses[2], rtol=1e-5)
    assert int(loop.state["opt"]["t"]) == int(states[3]["opt"]["t"]) == 3
    # the key third of qkv_b has a gradient of 0 in exact arithmetic
    # (softmax ignores a shift of a query's scores): both updates there are
    # AdamW-normalized rounding noise, left out as
    # tests/test_torch_train_step.py leaves it out
    H = SMALL["hidden"]
    for k, v in _flat_np(loop.state["params"]).items():
        want = _flat_np(states[3]["params"])[k]
        if k.endswith("qkv_b"):
            v, want = (np.delete(a, np.s_[H:2 * H], -1) for a in (v, want))
        np.testing.assert_allclose(v, want, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_bf16_training_state_from_jax_resumes_in_the_port(tmp_path,
                                                          no_auto_fusion):
    """The configuration the port trains on the card, at a tiny size:
    bf16 weights, bf16 moments, fp32 masters. JAX takes a step and saves
    {params, opt}; the port resumes it bitwise (every bf16 leaf by its
    bytes) and its next loss is JAX's next loss within the bf16
    trajectory tolerance of tests/test_torch_train_step.py (rtol 1e-3).
    The reference itself cannot resume this checkpoint (defect A)."""
    jc = jg.GPTConfig(**SMALL, dtype=jnp.bfloat16)
    mesh = build_mesh((1, 1, 1), ("dp", "pp", "mp"))
    jstep, jp, js = jts.make_sharded_train_step(
        jc, mesh, lr=LR, zero1=False, m_dtype="bfloat16",
        v_dtype="bfloat16")
    _, jp, js = jstep(jp, js, *_batch(0))
    saved = jax.tree.map(np.array, {"params": jp, "opt": js})
    loss2, _, _ = jstep(jp, js, *_batch(1))
    root = str(tmp_path / "ck")
    jck.save_checkpoint(jax.tree.map(jnp.asarray, saved), root, 1)
    dtypes = {info["dtype"] for info in json.loads(_read(os.path.join(
        jck.step_dir(root, 1), "metadata_0.json")))["state_dict_metadata"]
        .values()}
    assert dtypes == {"bfloat16", "float32", "int32"}
    tc = tg.GPTConfig(**SMALL, dtype=torch.bfloat16)
    loop = trs.make_resilient_loop(
        tc, root, step_kwargs=dict(lr=LR, device="cpu", m_dtype="bfloat16",
                                   v_dtype="bfloat16"),
        save_every=100, step_timeout=60.0)
    assert loop.resume() == 1
    want = _flat_np(_port_state_from(saved))
    got = _flat_np(loop.state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    np.testing.assert_allclose(loop.run_step(_batch(1)), float(loss2),
                               rtol=1e-3)
    jt = jax.tree.map(lambda a: pt.to_tensor(np.zeros(a.shape, np.float32))
                      .astype(str(a.dtype)), saved)
    assert jck.load_latest_valid(jt, root) is None


def test_resume_port_checkpoint_in_jax(tmp_path, no_auto_fusion):
    """The reverse: the port trains 2 steps from JAX's initial weights
    and saves; JAX loads the checkpoint bitwise and takes step 3, equal
    to its uninterrupted step 3."""
    losses, states, jstep = _jax_run(3)
    tc = tg.GPTConfig(**SMALL, dtype=torch.float32)
    step, _, _ = tts.make_train_step(tc, lr=LR, device="cpu")
    st0 = _port_state_from(states[0])
    step_fn, state = trs.adapt_train_step(step, st0["params"], st0["opt"])
    root = str(tmp_path / "ck")
    tlosses = []
    for s in range(2):
        loss, state = step_fn(state, _batch(s))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, losses[:2], rtol=1e-5)
    tck.save_checkpoint(state, root, 2)
    target = _jax_targets(states[2])
    assert jck.load_latest_valid(target, root) == 2
    for k, v in _flat_np(target).items():
        assert v.tobytes() == _flat_np(state)[k].tobytes(), k
    jstate = jax.tree.map(lambda t: t._data, target,
                          is_leaf=lambda x: isinstance(x, JTensor))
    loss, _, js = jstep(jstate["params"], jstate["opt"], *_batch(2))
    np.testing.assert_allclose(float(loss), losses[2], rtol=1e-5)
    assert int(js["t"]) == 3
