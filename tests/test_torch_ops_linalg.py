"""Every op of the port's ops/linalg.py against the reference's
(paddle_tpu/ops/linalg.py), on the CPU.

The cases are the op contracts' (``artifacts/op_contracts.json``) where
those run on data, else written here: the decompositions on matrices
where they are defined (positive definite for ``cholesky``, well
conditioned for the solves). The bar: fp32 outputs within rtol 1e-6 of
the reference (1e-6 of the output's largest magnitude for entries that
cancel), integers exact, the vjp of a seeded cotangent within rtol 1e-5.
Decompositions without a unique output (``qr``, ``svd``, ``eig*``,
``householder_product``'s inputs) are held by their invariants and
unique parts: reconstruction and orthogonality at 1e-5, singular values
and eigenvalues sorted at 1e-5, columns up to sign (elementwise
squares, which the sign does not change) at 1e-5, and the vjp of a loss
built from those parts. ``eig`` / ``eigvals`` run on the host in the
reference and are not differentiated there.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.dispatch import OpDef as RefOpDef
from paddle_tpu_torch.core.dispatch import OpDef as PortOpDef

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_ops_cases import (DECOMP_RTOL, LINALG_CASES, _TALL, assert_same,
                             contract_case, f32, spd, well)
from torch_ops_common import hold, npy, opdef, reference_op_flags, wrappers

port.set_device("cpu")

REF_OPS = wrappers(ref.ops.linalg)
PORT_OPS = wrappers(port.ops.linalg)


_PARAMS = [(name, cid) for name, cases in sorted(LINALG_CASES.items())
           for cid, _, _ in cases]


def test_linalg_registrations_are_the_references():
    flags = reference_op_flags("paddle_tpu/ops/linalg.py")
    assert set(PORT_OPS) == set(REF_OPS) == set(flags) == set(LINALG_CASES)
    assert len(flags) == 36
    for name, (diff, amp) in flags.items():
        p = opdef(PORT_OPS[name], PortOpDef)
        assert (p.differentiable, p.amp_policy) == (diff, amp), name
        assert port.OP_REGISTRY[name] is p


@pytest.mark.parametrize("name,cid", _PARAMS)
def test_linalg_op_against_reference(name, cid):
    factory, opts = next((f, o) for c, f, o in LINALG_CASES[name] if c == cid)
    r_def = opdef(REF_OPS[name], RefOpDef)
    case = contract_case(name, r_def.impl) if factory is None else factory()
    opts = {"differentiable": r_def.differentiable
            and opts.get("grad_inputs", True), **opts}
    hold(REF_OPS[name], PORT_OPS[name], case, name=f"{name}[{cid}]", **opts)


def test_qr_mode_r_tuples_rows_as_the_reference():
    (p, r) = hold(ref.qr, port.qr, ([_TALL], {"mode": "r"}),
                  check=lambda p, r: assert_same(np.abs(np.stack(p)),
                                                 np.abs(np.stack(r)),
                                                 DECOMP_RTOL, "|r|"),
                  differentiable=False, name="qr[r]")
    assert len(p) == len(r) == 3


def _rank_q(m, n, q, seed=0):
    """A rank-q [m, n] matrix whose columns have mean 0, so that
    pca_lowrank's centring keeps its rank."""
    left = f32(m, q, seed=seed)
    return ((left - left.mean(0)) @ f32(q, n, seed=seed + 1)) \
        .astype(np.float32)


@pytest.mark.parametrize("fn", ["svd_lowrank", "pca_lowrank"])
def test_lowrank_exact_on_rank_q_inputs(fn):
    """On a rank-4 input the randomized range finder is exact whatever
    its draw: at q 4 the singular values equal the reference's at 1e-5;
    at q 8 (oversampled: at q = rank the fp32 error of U S Vᵀ scales with
    the conditioning of the square 4 x 4 sketch) the leading four too,
    and U S Vᵀ equals the matrix and the reference's at 1e-5 of its
    largest magnitude."""
    a = _rank_q(40, 24, 4)
    for q in (4, 8):
        port.seed(3)
        ref.seed(3)
        pu, ps, pv = (npy(t) for t in getattr(port.linalg, fn)(
            port.to_tensor(a), q=q))
        ru, rs, rv = (npy(t) for t in getattr(ref.linalg, fn)(
            ref.to_tensor(a), q=q))
        assert_same(ps[:4], rs[:4], DECOMP_RTOL, f"s q {q}")
        if q == 8:
            rec_p, rec_r = (pu * ps) @ pv.T, (ru * rs) @ rv.T
            for want in (rec_r, a):
                np.testing.assert_allclose(
                    rec_p, want, rtol=0,
                    atol=DECOMP_RTOL * np.abs(a).max())


def test_fp8_half_gemm_is_an_fp32_product():
    # values that e4m3 holds exactly
    x = (np.round(f32(4, 8) * 4) / 4).astype(np.float32)
    y = (np.round(f32(6, 8, seed=1) * 4) / 4).astype(np.float32)
    b = f32(6, seed=2)
    kw = {"transpose_y": True, "scale": 0.5, "output_dtype": "bfloat16"}
    r = ref.linalg.fp8_fp8_half_gemm_fused(ref.to_tensor(x),
                                           ref.to_tensor(y),
                                           bias=ref.to_tensor(b), **kw)
    p = port.linalg.fp8_fp8_half_gemm_fused(port.to_tensor(x),
                                            port.to_tensor(y),
                                            bias=port.to_tensor(b), **kw)
    assert str(p.dtype).endswith("bfloat16")
    assert_same(npy(p.astype("float32")), npy(r).astype(np.float32), 0.0,
                "fp8 gemm")
    import torch

    p8 = port.linalg.fp8_fp8_half_gemm_fused(
        port.to_tensor(torch.from_numpy(x).to(torch.float8_e4m3fn)),
        port.to_tensor(torch.from_numpy(y).to(torch.float8_e4m3fn)),
        bias=port.to_tensor(b), **kw)
    assert_same(npy(p8.astype("float32")), npy(p.astype("float32")), 0.0,
                "fp8 inputs")


def test_linalg_tensor_methods():
    a = well(3)
    for name in ("norm", "inverse", "cholesky", "matrix_power", "det"):
        args = (2,) if name == "matrix_power" else ()
        x = spd(3) if name == "cholesky" else a
        pv = getattr(port.to_tensor(x), name)(*args)
        rv = getattr(ref.to_tensor(x), name)(*args)
        assert_same(npy(pv), npy(rv), 1e-6, name)


def test_batched_householder_product_defect_h():
    """Defect H: the reference's householder_product raises on a batch
    of matrices (``tau[..., i]`` of shape [B] meets the [B, m, m]
    products on their last axis); the port's batch equals its
    matrices one at a time, which equal the reference's."""
    x, tau = f32(2, 4, 3), f32(2, 3, seed=1)
    with pytest.raises(TypeError):
        ref.linalg.householder_product(ref.to_tensor(x), ref.to_tensor(tau))
    got = npy(port.linalg.householder_product(port.to_tensor(x),
                                              port.to_tensor(tau)))
    for i in range(2):
        want = npy(ref.linalg.householder_product(ref.to_tensor(x[i]),
                                                  ref.to_tensor(tau[i])))
        assert_same(got[i], want, 1e-6, f"householder_product[{i}]")
