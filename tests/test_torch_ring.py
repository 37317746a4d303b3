"""The port's ring attention against the JAX reference's, over gloo
ranks started by the port's launcher (tests/torch_sharded_worker.py),
the reference on the fake CPU devices with its compiler off.

- ``ring_attention`` at cp 4 on the mesh ("sep",), causal and not: each
  rank's output chunk and the gradients of its q, k and v chunks (from
  one output cotangent) against the reference's ``ring_attention`` and
  its vjp on the whole arrays; fp32 within rtol 1e-5 and an absolute
  floor of 1e-5 of the tensor's largest magnitude.
- ``ring_axis="mp"`` through ``make_sharded_train_step`` on (1, 1, 2)
  and (2, 1, 2), with the bars of tests/torch_sharded_common.py.
- ``ppermute`` and ``all_to_all_dim`` over 4 ranks, forward and
  backward (the reverse permutation; the move back), on tensors that
  name their rank.
- The transport, as tests/test_ring_aot.py holds the reference's
  program: the ring step sends k and v around the ring with ppermute (8
  sends a layer a step at mp 2: one hop of k and v forward, then k, v,
  dk and dv, and dk and dv home, backward); the Megatron-SP step on the
  same mesh sends none.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_sharded_common as C

RINGS = [dict(name=f"ring_cp4_{'causal' if c else 'full'}", kind="ring",
              cp=4, causal=c) for c in (True, False)]
RING_CFG = dict(C.SMALL, ring_axis="mp")
STEPS2 = [C.case("ring_mp2", [1, 1, 2], cfg=RING_CFG, count=True),
          C.case("sp_mp2", [1, 1, 2], count=True)]
STEPS4 = [C.case("ring_dp2_mp2", [2, 1, 2], cfg=RING_CFG)]
TRANSPORT = dict(name="transport", kind="transport", n=4)
SHAPE = (2, 32, 4, 16)          # B, S, H, D


def _prepare_ring(case, root):
    if case["kind"] == "transport":
        return lambda: None
    from paddle_tpu.distributed.process_mesh import build_mesh
    from paddle_tpu.parallel.ring_attention import ring_attention

    rng = np.random.RandomState(7)
    q, k, v, do = (rng.standard_normal(SHAPE).astype(np.float32)
                   for _ in range(4))
    np.savez(os.path.join(root, f"{case['name']}.in.npz"), q=q, k=k, v=v,
             do=do)
    mesh = build_mesh((case["cp"],), ("sep",))

    def reference():
        with jax.sharding.set_mesh(mesh):
            o, vjp = jax.vjp(lambda a, b, c: ring_attention(
                a, b, c, mesh, axis="sep", causal=case["causal"]),
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            dq, dk, dv = vjp(jnp.asarray(do))
        return {n: np.asarray(a) for n, a in
                (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}

    return reference


def _runs(tmp_path_factory, tag, cases, nprocs):
    root = str(tmp_path_factory.mktemp(tag))
    return root, C.run_all(root, cases, nprocs=nprocs,
                           prepare=_prepare_ring)


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return _runs(tmp_path_factory, "ring2", STEPS2, 2)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _runs(tmp_path_factory, "ring4", RINGS + STEPS4 + [TRANSPORT], 4)


def _close(got, want, what):
    floor = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor,
                               err_msg=what)


@pytest.mark.parametrize("case", RINGS, ids=[c["name"] for c in RINGS])
def test_ring_attention_matches_the_reference(runs4, case):
    root, results = runs4
    ref = results[case["name"]]
    n = SHAPE[1] // case["cp"]
    for r in range(case["cp"]):
        got = np.load(os.path.join(root, f"{case['name']}.r{r}.npz"))
        for key in ("o", "dq", "dk", "dv"):
            _close(got[key], ref[key][:, r * n:(r + 1) * n],
                   f"{key} rank {r}")


@pytest.mark.parametrize("case", STEPS2 + STEPS4,
                         ids=[c["name"] for c in STEPS2 + STEPS4])
def test_ring_step_matches_the_reference(request, case):
    n = int(np.prod(case["mesh"]))
    root, results = request.getfixturevalue(f"runs{n}")
    C.check_case(case, results[case["name"]], root)


def test_the_ring_step_rotates_k_and_v_and_the_sp_step_does_not(runs2):
    root, _ = runs2
    L, steps = C.SMALL["n_layers"], STEPS2[0]["steps"]
    for r in range(2):
        ring = np.load(os.path.join(root, f"ring_mp2.r{r}.npz"))
        sp = np.load(os.path.join(root, f"sp_mp2.r{r}.npz"))
        assert int(ring["count/ppermute_sends"]) == 8 * L * steps
        assert int(sp["count/ppermute_sends"]) == 0


def test_ppermute_and_all_to_all_forward_and_backward(runs4):
    root, _ = runs4
    n = TRANSPORT["n"]
    for r in range(n):
        got = np.load(os.path.join(root, f"transport.r{r}.npz"))
        # rank r receives rank r-1's tensor (rank 0 nothing: zeros) and
        # its cotangent, r+1, goes back to rank r-1
        assert np.all(got["y"] == (r if r else 0))
        assert np.all(got["dx"] == (r + 2 if r < n - 1 else 0))
        # rank r holds T-block r of every rank's heads, in rank order
        want = np.concatenate(
            [np.arange(2 * n * 3, dtype=np.float32).reshape(2, n, 3)[
                :, r:r + 1] + 100 * i for i in range(n)], axis=2)
        assert np.array_equal(got["b"], want)
    # the backward is the move back: rank i's element (b, t, c) took the
    # cotangent of its place in rank t's output, (b, 0, i * 3 + c)
    idx = np.arange(2 * 1 * 3 * n).reshape(2, 1, 3 * n)
    for i in range(n):
        got = np.load(os.path.join(root, f"transport.r{i}.npz"))["da"]
        want = np.stack([idx[:, 0, i * 3:(i + 1) * 3]] * n, axis=1)
        assert np.array_equal(got, want.astype(np.float32))
