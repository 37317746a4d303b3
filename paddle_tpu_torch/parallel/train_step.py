"""The single-device GPT training step: forward, backward and AdamW
(port of paddle_tpu/parallel/train_step.py, ``make_sharded_train_step``
on a one-device mesh).

The reference wraps its whole step in ``compiler.auto_fuse``; here the
forward is fused inside ``models/gpt.py::model_apply`` (``fused_call``)
and nothing more. That covers what the step-level pass can find: the
backward is autograd's (the fused entries carry their own composed
backwards, as the reference's custom_vjps do) and AdamW is a loop of
in-place updates with no catalog chain in it. tests/test_torch_compiler.py
holds the port's per-template site counts (2L + 1 ``layer_epilogue``,
L ``bias_gelu``) equal to the JAX compiler's on the same unrolled model,
where the JAX compiler runs.

AdamW keeps the reference's arithmetic: fp32 update math, bias
corrections in fp32, weight decay on every leaf, moments stored as fp32,
bf16 or blockwise int8 (sqrt companding, blocks of 2048), and in master
mode (``param_dtype`` != ``dtype``) the >= 2-D leaves live in the compute
dtype with fp32 masters in the state. ``weights="sr-bf16"`` keeps no
master: the >= 2-D leaves live in bf16 and each update is written back by
stochastic rounding (16 uniform bits added below bf16's mantissa cut of
the fp32 bits, then truncation), whose noise comes from a
``torch.Generator`` on the parameters' device, seeded from the step's
``seed``; the reference's rbg keys give bits its backend defines, so the
port is held to the reference's statistical checks, not its bits. Where
the reference donates its buffers to the jitted step, the port updates
parameters, masters and moments in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.flags import GLOBAL_FLAGS
from ..models.gpt import GPTConfig, init_params, loss_fn

__all__ = ["adamw_init", "adamw_update", "make_train_step"]

_QBLOCK = 2048
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _is_quant(x) -> bool:
    return isinstance(x, dict) and "qm" in x


def _tree_map(fn, tree, *rest):
    """Map over nested dicts; an int8 moment {"qm", "qs"} is one leaf."""
    if isinstance(tree, dict) and not _is_quant(tree):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _master_leaf(a):
    """fp32 master of a >= 2-D leaf; 1-D leaves stay fp32 in the params
    themselves, so their master is a size-0 placeholder."""
    if a.dim() >= 2:
        return a.detach().to(torch.float32, copy=True)
    return torch.zeros((0,), dtype=torch.float32, device=a.device)


def _sqrt(x32):
    """Correctly rounded fp32 sqrt. CUDA's is; PyTorch's vectorized CPU
    sqrt is not (it differs from IEEE in the last bit for ~0.6% of
    inputs), so on the CPU it goes through fp64, whose rounding to fp32
    is exact."""
    if x32.is_cuda:
        return torch.sqrt(x32)
    return torch.sqrt(x32.double()).float()


def _quantize_moment(x32):
    """Blockwise absmax int8 with sqrt companding: {'qm': int8 [nb, 2048],
    'qs': fp32 [nb]}. torch.round rounds half to even, as jnp.round."""
    flat = x32.reshape(-1)
    pad = (-flat.numel()) % _QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1)
    nrm = blocks / torch.clamp_min(scale, 1e-20)[:, None]
    nrm = torch.sign(nrm) * _sqrt(nrm.abs())
    q = torch.clamp(torch.round(nrm * 127.0), -127, 127).to(torch.int8)
    return {"qm": q, "qs": scale}


def _dequantize_moment(mq, like):
    """fp32 tensor shaped like ``like`` from any moment representation."""
    if not _is_quant(mq):
        return mq.float()
    nrm = mq["qm"].float() / 127.0
    nrm = torch.sign(nrm) * torch.square(nrm)
    flat = (nrm * mq["qs"][:, None]).reshape(-1)
    return flat[:like.numel()].reshape(like.shape)


def _stochastic_round(x32, dtype, generator: torch.Generator):
    """fp32 -> ``dtype``; to bf16 by stochastic rounding: 16 uniform
    random bits added to the fp32 bits below bf16's mantissa cut, then
    truncated, so that the rounding is unbiased. The add runs on an int32
    view, which wraps modulo 2^32 as the reference's uint32 add does.
    Other dtypes are a plain cast (fp32 1-D leaves pass through)."""
    if dtype != torch.bfloat16:
        return x32.to(dtype)
    r = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                      device=x32.device, dtype=torch.int32)
    r += x32.contiguous().view(torch.int32)
    r &= -(1 << 16)                             # 0xFFFF0000
    return r.view(torch.float32).to(dtype)


def _store_moment(x32, dtype):
    if dtype == "int8":
        return _quantize_moment(x32)
    return x32.to(_DTYPES[dtype])


def _moment_like(a, dtype):
    if a.dim() < 2 or dtype in (None, "float32"):
        return torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    if dtype == "int8":
        return _quantize_moment(torch.zeros(a.shape, dtype=torch.float32,
                                            device=a.device))
    return torch.zeros(a.shape, dtype=_DTYPES[dtype], device=a.device)


def _moment_dtype_for(a, dtype):
    return "float32" if (a.dim() < 2 or dtype is None) else dtype


def adamw_init(params: dict, master_weights: bool = False,
               m_dtype: str | None = None, v_dtype: str | None = None) -> dict:
    """Zero moments in the chosen storage, step 0 and, with
    ``master_weights``, fp32 masters of the >= 2-D leaves."""
    dev = _leaves(params)[0].device
    state = {"m": _tree_map(lambda a: _moment_like(a, m_dtype), params),
             "v": _tree_map(lambda a: _moment_like(a, v_dtype), params),
             "t": torch.zeros((), dtype=torch.int32, device=dev)}
    if master_weights:
        state["master"] = _tree_map(_master_leaf, params)
    return state


def _write(dst, src) -> None:
    if _is_quant(dst):
        dst["qm"].copy_(src["qm"])
        dst["qs"].copy_(src["qs"])
    else:
        dst.copy_(src)


@torch.no_grad()
def adamw_update(params, grads, state, lr, wd=0.1, b1=0.9, b2=0.95,
                 eps=1e-8, m_dtype=None, v_dtype=None,
                 stochastic_round=False, sr_generator=None):
    """One AdamW step, written in place into ``params`` and ``state``
    (returned as well). ``grads`` is a tree like ``params``. With
    ``stochastic_round`` a leaf without a master is written back by
    stochastic rounding, its noise drawn from ``sr_generator`` (one draw
    per bf16 leaf per step), which must then be given."""
    if stochastic_round and sr_generator is None:
        raise ValueError("stochastic_round draws its noise from "
                         "sr_generator: pass a torch.Generator")
    t = state["t"] + 1
    bc1 = 1.0 - b1 ** t.float()
    bc2 = 1.0 - b2 ** t.float()
    masters = state.get("master")
    flat_mw = (_leaves(masters) if masters is not None
               else [None] * len(_leaves(params)))
    for p, g, m, v, mw in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"]),
                              flat_mw):
        has_master = mw is not None and mw.numel() > 0
        g32 = g.float()
        m32 = b1 * _dequantize_moment(m, p) + (1 - b1) * g32
        v32 = b2 * _dequantize_moment(v, p) + (1 - b2) * torch.square(g32)
        step = (m32 / bc1) / (_sqrt(v32 / bc2) + eps)
        p32 = mw if has_master else p.float()
        p32 = p32 - lr * (step + wd * p32)
        if has_master:
            mw.copy_(p32)
            p.copy_(p32.to(p.dtype))
        elif stochastic_round:
            p.copy_(_stochastic_round(p32, p.dtype, sr_generator))
        else:
            p.copy_(p32.to(p.dtype))
        _write(m, _store_moment(m32, _moment_dtype_for(p, m_dtype)))
        _write(v, _store_moment(v32, _moment_dtype_for(p, v_dtype)))
    state["t"].copy_(t)
    return params, state


def make_train_step(cfg: GPTConfig, lr: float = 1e-4, seed: int = 0,
                    m_dtype: str | None = None, v_dtype: str | None = None,
                    weights: str = "auto", device=None, mesh=None,
                    n_microbatches: int = 1):
    """Build ``(step_fn, params, opt_state)`` for one device.
    ``step_fn(params, opt_state, tokens, labels) -> (loss, params,
    opt_state)``; ``step_fn.put_batch`` puts a host batch on the device.
    Weights are drawn on the device from ``torch.Generator`` seeded with
    ``seed``. When ``cfg.param_dtype`` differs from ``cfg.dtype``, the
    >= 2-D leaves live in ``cfg.dtype`` and ``weights='auto'`` keeps fp32
    masters of them in the state, ``weights='sr-bf16'`` none (stochastic
    rounding, its noise from a generator seeded with ``seed``)."""
    if weights not in ("auto", "sr-bf16"):
        raise ValueError(f"weights mode {weights!r}: expected 'auto' or "
                         "'sr-bf16'")
    if mesh is not None or n_microbatches > 1:
        raise NotImplementedError("later slice: meshes and microbatches")
    if GLOBAL_FLAGS.get("dist_allreduce_quant"):
        raise NotImplementedError("later slice: dist_allreduce_quant")
    for name, dt in (("m_dtype", m_dtype), ("v_dtype", v_dtype)):
        if dt not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(f"{name}={dt!r}: expected None/'float32'/"
                             "'bfloat16'/'int8'")
    if v_dtype == "int8":
        raise ValueError("v_dtype='int8' is unsafe (zeroed second moments "
                         "explode the update); use 'bfloat16'")
    dev = resolve_device(device)
    low_precision = cfg.param_dtype != cfg.dtype
    sr = weights == "sr-bf16" and low_precision
    master = low_precision and not sr
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt_state = adamw_init(params, master_weights=master, m_dtype=m_dtype,
                           v_dtype=v_dtype)
    if low_precision:
        params = _tree_map(
            lambda a: a.to(cfg.dtype) if a.dim() >= 2 else a, params)
    sr_gen = torch.Generator(device=dev).manual_seed(seed) if sr else None

    def put_batch(arr):
        return torch.as_tensor(arr).to(dev)

    def step_fn(params, opt_state, tokens, labels):
        tokens = put_batch(tokens)
        labels = put_batch(labels)
        flat = _leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        grads = _tree_map(lambda _: next(it), params)
        adamw_update(params, grads, opt_state, lr, m_dtype=m_dtype,
                     v_dtype=v_dtype, stochastic_round=sr,
                     sr_generator=sr_gen)
        return loss.detach(), params, opt_state

    step_fn.put_batch = put_batch
    return step_fn, params, opt_state
