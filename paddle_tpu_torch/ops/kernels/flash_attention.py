"""Causal flash attention: the CUDA kernels' wrappers, their plain
PyTorch versions and the differentiable operators.

Port of paddle_tpu/ops/pallas/flash_attention.py, native layout, two
entries:

- ``flash_attention_qkv_raw`` on the fused qkv projection (GPT): forward
  ``_flash_fwd_kernel_native`` (K1), backward the merged
  ``_flash_bwd_fused_kernel_native`` (K2, one dqkv cotangent) where
  ``fused_dqkv_ok`` holds and the flag ``flash_attention_fused_dqkv`` is
  on, else the split ``_flash_bwd_dq_kernel_native`` +
  ``_flash_bwd_dkv_kernel_native`` (K3), as the reference chooses;
- ``flash_attention_raw`` on separate q, k, v [B, S, h, d] (LLaMA, and
  GPT where the fused gate fails): the same forward kernel given three
  base pointers and row strides (K1's separate-input mode,
  ``flash_fwd_sep``), backward K3 in its separate mode
  (``flash_bwd_sep``). Under ``flash_attention_native_layout=0``, or
  where the reference's lane fusion fails (``_native_supported``: d 64
  with an odd head count), it takes the head-major route instead, as the
  reference does: q, k, v transposed to [B, h, S, d], forward
  ``flash_fwd_hm`` and split backward ``flash_bwd_hm`` (K17,
  ``_flash_fwd_kernel`` / ``_flash_bwd_dq_kernel`` /
  ``_flash_bwd_dkv_kernel``), the same CUDA bodies with head strides, so
  bit-equal to K1-sep and K3-sep on the same values.

- qkv [B, S, 3*h*d]: q, k and v at lane offsets 0, h*d and 2*h*d, head
  j at j*d inside each; read in place, never split into copies.
- forward: o [B, S, h, d] in qkv's dtype and lse [B, h, S] fp32.
  s = (q k^T) * sm_scale in fp32, causal fill -1e30, p = exp(s - m) with
  l summed over the fp32 p, p cast to the input dtype before p v,
  o = acc / l, lse = m + log(l).
- backward: dqkv [B, S, 3*h*d] (or dq, dk, dv [B, S, h, d]).
  p = exp(s - lse) (masked 0), dp = do v^T, ds = p (dp - delta) cast to
  the input dtype, dq = ds k * scale, dk = ds^T q * scale, dv = p^T do
  with p cast; delta = rowsum(do * o) in fp32 is the torch expression
  here before K2, K3 or K17's backward (the reference's XLA reduction).
  K2 and K3 compute the same function, bit for bit.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch ``csrc/flash_attention.cu`` or raise. ``flash_plan`` is the
kernels' choice of variant and tiles for a shape, the one the C
launchers make: bf16 at head dim 64 or 128 takes the TMA + wgmma bodies
(128-row blocks, a ring of TMA tiles, heaviest blocks first), fp32 and
head dim 256 the CUDA-core ones. Every entry counts its launches by the
variant the C launcher reports it launched (``launches_wgmma``,
``launches_fma``; ``launches`` is their sum) and by shape in
``LAUNCHES_BY_PLAN``. The differentiable
entry ``flash_attention_qkv`` is the registered operator pair
``paddle_tpu_torch::flash_qkv_fwd`` / ``flash_qkv_bwd`` (K2 or K3 as the
forward's registered backward, chosen when the backward runs; every
choice is counted in ``BWD_ROUTES`` on any device), and
``flash_attention_raw`` the registered operator
``paddle_tpu_torch::flash_fwd_sep`` (o and lse; K3 as its backward) or,
head-major, ``paddle_tpu_torch::flash_fwd_hm`` (K17), so that the fusion
compiler's trace records each as one node, with shape-only fake
implementations (the ``rope_attention`` template finds the separate
entry by its operator; the remat policies save every flash operator's o
and lse).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ...core.flags import GLOBAL_FLAGS
from . import _build

__all__ = ["flash_attention_qkv", "flash_qkv_supported", "flash_fwd",
           "flash_bwd", "flash_fwd_plain", "flash_bwd_plain",
           "flash_attention_raw", "flash_supported", "flash_fwd_sep",
           "flash_sep_plain", "flash_bwd_split", "flash_bwd_sep",
           "flash_bwd_sep_plain", "fused_dqkv_ok", "BWD_ROUTES",
           "RAW_ROUTES", "flash_fwd_hm", "flash_bwd_hm", "flash_fwd_hm_plain",
           "flash_bwd_hm_plain", "flash_plan", "LAUNCHES_BY_PLAN"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_FLAG_DEFAULTS = (("flash_attention_kernel_bwd", True),
                  ("flash_attention_native_layout", True),
                  ("use_library_flash_attention", False))
_fns = {}
# the fused-qkv backward's route, counted on every device: "merged" (K2)
# or "split" (K3)
BWD_ROUTES = {"merged": 0, "split": 0}
# flash_attention_raw's forward layout, counted on every device where the
# operator runs (not while a trace records it): "native" (K1-sep) or
# "head_major" (K17)
RAW_ROUTES = {"native": 0, "head_major": 0}
_MIN_BLOCK, _MAX_BLOCK = 128, 512
# launches on CUDA tensors by (variant, dtype, head dim, S, part, bh), the
# variant as the C launcher reports it, part "fwd", "both" (K2), "dq" or
# "dkv" (K3, K17's backward), bh the (batch, head) pairs: every flash
# entry's, K11's too
LAUNCHES_BY_PLAN: collections.Counter = collections.Counter()

# the tile loops' geometry (csrc/flash_fwd.cuh)
FLASH_ROWS = 128            # rows a block: two consumer warpgroups of 64
FLASH_FWD_KEYS = 128        # keys a forward ring tile
FLASH_BWD_TILE = 64         # keys (dq) or queries (dk/dv) a backward tile
FLASH_MAX_STAGES = 4
FLASH_SMEM = 232448         # shared memory a block may take (227 KB)
FLASH_SMEM_FIXED = 1024 + 256   # base alignment, mbarriers
FLASH_L2_CHUNK = 16 << 20       # L2 bytes a chunk of the work order reads
FMA_ROWS, FMA_TILE = 64, 32     # the CUDA-core kernels' block and tile
_PARTS = ("fwd", "both", "dq", "dkv")
_VARIANTS = ("fma", "wgmma")    # the C entries' *variant codes 0 and 1


def _variant(d: int, dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "fma"


def flash_plan(S: int, d: int, dtype=torch.bfloat16, part: str = "fwd",
               causal: bool = True, bh: int = 1) -> dict:
    """The kernel variant and tiles for a flash launch at sequence S and
    head dim d over ``bh`` (batch, head) pairs; ``part`` is "fwd" (K1,
    K1-sep, K11, K17's forward), "both" (K2) or "dq" / "dkv" (K3's two
    launches, K17's backward).

    ``variant``: "wgmma" for bf16 at d 64 or 128, else "fma". For
    "wgmma": ``rows`` a work item (128: two consumer warpgroups of 64; at
    S % 128 == 64 the last row block's second half lies past S, where TMA
    reads zeros and nothing is stored), ``tile`` rows a ring stage (128
    keys in the forward, 64 keys or queries in the backward), ``stages``
    of the TMA ring (as many as 227 KB holds beside the item's own tiles,
    up to 4; the forward has a k ring of ``stages`` and a v ring of
    ``v_stages`` beside two q buffers) and the ``smem`` bytes, as the
    source lays them out. The work order: the (batch, head) pairs in
    ``chunk``s whose two streamed operands (S x d bf16 each: k and v, or
    q and do) fit in 16 MiB of L2;
    within a chunk the row blocks in ``order``, each taken by every pair
    of the chunk before the next: heaviest first, descending for the
    causal forward and dq (block i has i + 1 tiles), ascending for dk/dv
    (block i has S / 64 - 2 i) and K2 (equal work). For "fma": 64-row
    blocks of 32-row tiles in grid order."""
    if part not in _PARTS:
        raise ValueError(f"part {part!r} not in {_PARTS}")
    if S <= 0 or S % 64:
        raise ValueError(f"S {S}: the kernels take S % 64 == 0")
    if _variant(d, dtype) == "fma":
        return {"variant": "fma", "rows": FMA_ROWS, "tile": FMA_TILE,
                "stages": 0, "v_stages": 0, "smem": 0,
                "order": list(range(S // FMA_ROWS)), "chunk": 0}
    own_tile = FLASH_ROWS * d * 2
    room = FLASH_SMEM - FLASH_SMEM_FIXED
    if part == "fwd":     # two q buffers, then k and v rings of tiles
        tile = FLASH_FWD_KEYS
        slots = (room - 2 * own_tile) // (tile * d * 2)
        v_stages = min(FLASH_MAX_STAGES, (slots + 1) // 2)
        stages = min(FLASH_MAX_STAGES, slots - v_stages)
        smem = 2 * own_tile + (stages + v_stages) * tile * d * 2
    else:                 # the own tiles, then stages of two tiles + stats
        tile = FLASH_BWD_TILE
        own = own_tile * (4 if part == "both" else 2)
        stage = 2 * tile * d * 2 + 2 * tile * 4      # + lse, delta
        stages = min(FLASH_MAX_STAGES, (room - own) // stage)
        v_stages, smem = 0, own + stages * stage
    blocks = list(range(-(-S // FLASH_ROWS)))
    if causal and part in ("fwd", "dq"):
        blocks.reverse()
    chunk = max(1, min(bh, FLASH_L2_CHUNK // (2 * S * d * 2)))
    return {"variant": "wgmma", "rows": FLASH_ROWS, "tile": tile,
            "stages": stages, "v_stages": v_stages,
            "smem": FLASH_SMEM_FIXED + smem, "order": blocks,
            "chunk": chunk}


def flash_plan_c(S: int, d: int, dtype, part: str = "fwd",
                 causal: bool = True, bh: int = 1) -> dict:
    """The plan the C launchers follow (``flash_plan_c`` in the library),
    in flash_plan's keys: built on first use, for holding flash_plan to
    the source on the card."""
    fn = _fns.get("flash_plan_c")
    if fn is None:
        fn = _build.library("flash_attention").flash_plan_c
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["flash_plan_c"] = fn
    out = (ctypes.c_int * 8)()
    _build.check(fn(S, d, _DTYPE_CODE[dtype], _PARTS.index(part),
                    int(causal), bh, ctypes.addressof(out)), "flash_plan_c")
    variant, rows, tile, stages, smem, reverse, chunk, v_stages = out
    blocks = list(range(S // rows if variant == 0 else -(-S // rows)))
    if reverse:
        blocks.reverse()
    return {"variant": "wgmma" if variant else "fma", "rows": rows,
            "tile": tile, "stages": stages, "v_stages": v_stages,
            "smem": smem, "order": blocks, "chunk": chunk}


def _launch(c_fn, name: str, *args) -> str:
    """Call C entry ``c_fn`` (named ``name`` in errors) with ``args`` and
    its trailing *variant out-parameter; raise on a CUDA error, else
    return the variant it launched ("wgmma" or "fma")."""
    variant = ctypes.c_int(-1)
    _build.check(c_fn(*args, ctypes.byref(variant)), name)
    return _VARIANTS[variant.value]


def _count(fn, shape, dtype, part: str, variant: str) -> None:
    """Count a CUDA launch of entry ``fn`` at (B, S, h, d) by the variant
    the launcher reported and by shape."""
    B, S, h, d = shape
    setattr(fn, "launches_" + variant, getattr(fn, "launches_" + variant) + 1)
    LAUNCHES_BY_PLAN[(variant, _DTYPE_NAME[dtype], d, S, part, B * h)] += 1
    fn.launches += 1


def _check_flags() -> None:
    """The XLA-expression backward and a library kernel are paths of a
    later slice: refuse them rather than run this one under their
    names. ``flash_attention_native_layout=0`` is honoured (K17)."""
    for name, default in _FLAG_DEFAULTS:
        if name != "flash_attention_native_layout" and \
                GLOBAL_FLAGS.get(name) != default:
            raise NotImplementedError(
                f"later slice: FLAGS_{name}={GLOBAL_FLAGS.get(name)} (only "
                f"{default} is ported)")


def _heads_per_program(h: int, d: int) -> int:
    """The reference's lane fusion: heads a TPU program takes so that
    its block's lane width hp*d is a 128-multiple (d 64 -> 2)."""
    return max(1, 128 // d)


def _native_supported(h: int, d: int) -> bool:
    """The reference's native-layout gate: h a multiple of hp and hp*d
    a 128-multiple; where it fails the head-major kernels (K17) run."""
    hp = _heads_per_program(h, d)
    return h % hp == 0 and (hp * d) % 128 == 0


def flash_qkv_supported(shape, n_heads: int, dtype) -> bool:
    """The reference's gate for the fused entry: the native layout on,
    [B, S, 3*h*d] with S a multiple of 128, d in (64, 128, 256) and h
    even for d 64 (its 128-lane head pairs), and fp32 or bf16, the
    dtypes the kernels take. Raises while a refused flash flag is off
    its default."""
    _check_flags()
    if not GLOBAL_FLAGS.get("flash_attention_native_layout"):
        return False
    if len(shape) != 3 or shape[2] % (3 * n_heads):
        return False
    d = shape[2] // (3 * n_heads)
    return (shape[1] % 128 == 0 and shape[1] >= 128
            and d in SUPPORTED_HEAD_DIMS and _native_supported(n_heads, d)
            and dtype in _DTYPE_CODE)


def flash_supported(shape, dtype) -> bool:
    """The reference's gate for the separate entry (``supported``): [B, S,
    h, d] with S a multiple of 128 and d in (64, 128, 256), and fp32 or
    bf16, the dtypes the kernel takes. Raises while a refused flash flag
    is off its default."""
    _check_flags()
    return (len(shape) == 4 and shape[1] % 128 == 0 and shape[1] >= 128
            and shape[3] in SUPPORTED_HEAD_DIMS and dtype in _DTYPE_CODE)


def _block(s: int) -> int:
    """The reference's default square block (``_block_sizes``): the
    largest multiple of 128 dividing ``s``, at most 512 (0 if none)."""
    b = min(_MAX_BLOCK, s)
    b -= b % _MIN_BLOCK
    while b >= _MIN_BLOCK and s % b:
        b -= _MIN_BLOCK
    return b


def fused_dqkv_ok(s: int, hd: int, itemsize: int) -> bool:
    """The reference's gate of the merged backward (``_fused_dqkv_ok``):
    a square block of at least 128 rows, and the four full-sequence
    slabs one program holds (k, v, q, do at [s, hd], hd = hp * d) within
    6 MiB. It is a TPU memory cap that K2 does not need; mirroring it
    keeps the port's choice of K2 or K3 the reference's."""
    return _block(s) >= _MIN_BLOCK and 4 * s * hd * itemsize <= 6 * 2 ** 20


def _split(qkv: torch.Tensor, n_heads: int):
    B, S, H3 = qkv.shape
    H = H3 // 3
    d = H // n_heads
    return [qkv[..., i * H:(i + 1) * H].reshape(B, S, n_heads, d).float()
            for i in range(3)]


def _mask(S: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def _fwd_plain(q, k, v, dt, causal: bool, sm_scale: float):
    """(o [B, S, h, d] in ``dt``, lse [B, h, S] fp32) from fp32 q, k, v by
    one masked softmax over the whole sequence, with the kernel's cast
    points."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if causal:
        s = torch.where(_mask(s.shape[-1], s.device), s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                    # [B, h, S]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v)
    o = (acc / l.transpose(1, 2)[..., None]).to(dt)
    return o, m[..., 0] + torch.log(l)


def flash_fwd_plain(qkv, n_heads: int, causal: bool, sm_scale: float):
    """(o [B, S, h, d], lse [B, h, S] fp32) of the fused qkv."""
    return _fwd_plain(*_split(qkv, n_heads), qkv.dtype, causal, sm_scale)


def flash_sep_plain(q, k, v, causal: bool, sm_scale: float):
    """(o [B, S, h, d], lse [B, h, S] fp32) of separate q, k, v
    [B, S, h, d]."""
    return _fwd_plain(q.float(), k.float(), v.float(), q.dtype, causal,
                      sm_scale)


def _bwd_plain(q, k, v, o, lse, do, dt, causal: bool, sm_scale: float):
    """fp32 (dq, dk, dv) [B, S, h, d] from fp32 q, k, v, the saved o and
    lse, with the kernels' cast points to ``dt``."""
    S = q.shape[1]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, h, S]
    do_ = do.to(dt).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_mask(S, p.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_, v)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do_)
    return dq, dk, dv


def flash_bwd_plain(qkv, o, lse, do, n_heads: int, causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """dqkv [B, S, 3*h*d] in qkv's dtype, from the saved o and lse (the
    function of K2 and of K3's fused-qkv mode)."""
    B, S, H3 = qkv.shape
    grads = _bwd_plain(*_split(qkv, n_heads), o, lse, do, qkv.dtype, causal,
                       sm_scale)
    return torch.cat([t.reshape(B, S, H3 // 3) for t in grads],
                     dim=-1).to(qkv.dtype)


def flash_bwd_sep_plain(q, k, v, o, lse, do, causal: bool,
                        sm_scale: float):
    """(dq, dk, dv) [B, S, h, d] in q's dtype of separate q, k, v (K3's
    separate mode)."""
    grads = _bwd_plain(q.float(), k.float(), v.float(), o, lse, do, q.dtype,
                       causal, sm_scale)
    return tuple(t.to(q.dtype) for t in grads)


def flash_fwd_hm_plain(q, k, v, causal: bool, sm_scale: float):
    """(o [B, h, S, d], lse [B, h, S] fp32) of head-major q, k, v (K17's
    function: K1-sep's on the transposed operands)."""
    o, lse = flash_sep_plain(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal, sm_scale)
    return o.transpose(1, 2).contiguous(), lse


def flash_bwd_hm_plain(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """(dq, dk, dv) [B, h, S, d] in q's dtype of head-major operands."""
    grads = flash_bwd_sep_plain(*(t.transpose(1, 2)
                                  for t in (q, k, v, o)), lse,
                                do.transpose(1, 2), causal, sm_scale)
    return tuple(t.transpose(1, 2).contiguous() for t in grads)


# (pointers, ints) before the common (B, S, h, d, causal, scale, dtype,
# [sched,] stream, variant) of each C entry
_ARGS = {"flash_fwd": (3, 0), "flash_fwd_sep": (5, 0), "flash_bwd": (5, 0),
         "flash_bwd_dq": (7, 2), "flash_bwd_dkv": (8, 2),
         "flash_fwd_hm": (5, 0), "flash_bwd_hm_dq": (7, 0),
         "flash_bwd_hm_dkv": (8, 0)}
_FWD = ("flash_fwd", "flash_fwd_sep", "flash_fwd_hm")


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = ([P] * n_ptr + [I] * (n_int + 5)
                       + [ctypes.c_float, I] + [P] * (2 if name in _FWD
                                                      else 1)
                       + [ctypes.POINTER(I)])
        fn.restype = I
        _fns[name] = fn
    return fn


_SCHED: dict = {}           # (device, stream) -> the stream's scratch
_CAPTURE_SLOTS = 1024
_CAPTURED: dict = {}        # device -> [zeroed slots, next free slot]


def sched_scratch(t: torch.Tensor, stream: int) -> torch.Tensor:
    """Scheduling scratch for a persistent forward on ``t``'s device and
    ``stream`` (the current one's handle): two int32, zero before the
    launch, which leaves them zero. Launches on one stream run one after
    another, so eager ones share a buffer a stream. A launch that a CUDA
    graph captures owns a slot of its own for good (from slots zeroed by
    the first eager launch on the device, or else a fresh buffer zeroed
    by a captured fill), so that no replay shares a counter with another
    launch. Keep the tensor until the launch is queued."""
    if torch.cuda.is_current_stream_capturing():
        slots = _CAPTURED.get(t.device)
        if slots is None or slots[1] == _CAPTURE_SLOTS:
            return torch.zeros(2, dtype=torch.int32, device=t.device)
        slots[1] += 1
        return slots[0][slots[1] - 1]
    key = (t.device, stream)
    buf = _SCHED.get(key)
    if buf is None:
        buf = _SCHED[key] = torch.zeros(2, dtype=torch.int32,
                                        device=t.device)
        if t.device not in _CAPTURED:
            _CAPTURED[t.device] = [torch.zeros(
                (_CAPTURE_SLOTS, 2), dtype=torch.int32, device=t.device), 0]
    return buf


def _check_cuda(qkv, n_heads: int, *others) -> tuple[int, int, int, int]:
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv dtype {qkv.dtype}: the kernels take float32 "
                        "or bfloat16")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * n_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3*h*d] for "
                         f"{n_heads} heads")
    B, S, H3 = qkv.shape
    d = H3 // (3 * n_heads)
    if d not in SUPPORTED_HEAD_DIMS or S % 64:
        raise ValueError(f"head dim {d} / seq {S}: the kernels take d in "
                         f"{SUPPORTED_HEAD_DIMS} and S % 64 == 0")
    for t in (qkv, *others):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous and on "
                             f"{qkv.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return B, S, n_heads, d


def flash_fwd(qkv, n_heads: int, causal: bool, sm_scale: float):
    """K1: (o, lse). Counts its CUDA launches in ``flash_fwd.launches``
    (by variant: ``launches_wgmma``, ``launches_fma``)."""
    if qkv.device.type == "cpu":
        return flash_fwd_plain(qkv, n_heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, h, d = _check_cuda(qkv, n_heads)
    o = torch.empty((B, S, h, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, h, S), dtype=torch.float32, device=qkv.device)
    stream = _stream(qkv)
    sched = sched_scratch(qkv, stream)
    variant = _launch(
        _kernel("flash_fwd"), "flash_fwd", qkv.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, h, d, int(causal), float(sm_scale),
        _DTYPE_CODE[qkv.dtype], sched.data_ptr(), stream)
    _count(flash_fwd, (B, S, h, d), qkv.dtype, "fwd", variant)
    return o, lse


def _bwd_operands(o, lse, do, dtype, shape, head_major: bool = False):
    """(delta [B, h, S] fp32, do in ``dtype``), both contiguous, after
    checking o, do and lse [B, h, S] fp32 against ``shape`` = (B, S, h,
    d); o and do are [B, S, h, d], or [B, h, S, d] with ``head_major``.
    delta is the fp32 row sum of do * o over d (the reference's XLA
    reduction before its kernels), the same expression as the plain
    versions' on every dtype."""
    B, S, h, d = shape
    want = (B, h, S, d) if head_major else shape
    if o.shape != want or do.shape != want or \
            lse.shape != (B, h, S) or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} / lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match "
                         f"{want}")
    delta = (do.float() * o.float()).sum(-1)
    if not head_major:
        delta = delta.transpose(1, 2)
    return delta.contiguous(), do.to(dtype).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_bwd(qkv, o, lse, do, n_heads: int, causal: bool,
              sm_scale: float) -> torch.Tensor:
    """K2: dqkv, deterministic (no atomics). Counts its CUDA launches in
    ``flash_bwd.launches``."""
    if qkv.device.type == "cpu":
        return flash_bwd_plain(qkv, o, lse, do, n_heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, h, d = _check_cuda(qkv, n_heads, lse)
    delta, do_ = _bwd_operands(o, lse, do, qkv.dtype, (B, S, h, d))
    _check_cuda(qkv, n_heads, do_, delta)
    dqkv = torch.empty_like(qkv)
    variant = _launch(
        _kernel("flash_bwd"), "flash_bwd", qkv.data_ptr(), do_.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, S, h, d,
        int(causal), float(sm_scale), _DTYPE_CODE[qkv.dtype], _stream(qkv))
    _count(flash_bwd, (B, S, h, d), qkv.dtype, "both", variant)
    return dqkv


def _launch_split(entry, q, k, v, do_, lse, delta, dq, dk, dv, row_in: int,
                  row_out: int, shape, causal: bool, sm_scale: float,
                  dtype) -> None:
    """K3's two launches, dq then dk/dv, counted on ``entry``."""
    B, S, h, d = shape
    tail = (B, S, h, d, int(causal), float(sm_scale), _DTYPE_CODE[dtype],
            _stream(do_))
    ins = (q, k, v, do_.data_ptr(), lse.data_ptr(), delta.data_ptr())
    variant = _launch(_kernel("flash_bwd_dq"), "flash_bwd_dq", *ins, dq,
                      row_in, row_out, *tail)
    _count(entry, shape, dtype, "dq", variant)
    variant = _launch(_kernel("flash_bwd_dkv"), "flash_bwd_dkv", *ins, dk,
                      dv, row_in, row_out, *tail)
    _count(entry, shape, dtype, "dkv", variant)


def flash_bwd_split(qkv, o, lse, do, n_heads: int, causal: bool,
                    sm_scale: float) -> torch.Tensor:
    """K3 in its fused-qkv mode: dqkv, from the dq and the dk/dv kernels
    writing into one buffer at lane offsets 0, H and 2H (no
    concatenate); bit-equal to K2. Counts its CUDA launches (two a call)
    in ``flash_bwd_split.launches``."""
    if qkv.device.type == "cpu":
        return flash_bwd_plain(qkv, o, lse, do, n_heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, S, h, d = _check_cuda(qkv, n_heads, lse)
    delta, do_ = _bwd_operands(o, lse, do, qkv.dtype, (B, S, h, d))
    _check_cuda(qkv, n_heads, do_, delta)
    dqkv = torch.empty_like(qkv)
    H, es = h * d, qkv.element_size()
    src, dst = qkv.data_ptr(), dqkv.data_ptr()
    _launch_split(
        flash_bwd_split, src, src + H * es, src + 2 * H * es, do_, lse,
        delta, dst, dst + H * es, dst + 2 * H * es, 3 * H, 3 * H,
        (B, S, h, d), causal, sm_scale, qkv.dtype)
    return dqkv


def flash_bwd_sep(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """K3 in its separate mode: (dq, dk, dv) [B, S, h, d] of separate q,
    k, v. Counts its CUDA launches (two a call) in
    ``flash_bwd_sep.launches``."""
    if q.device.type == "cpu":
        return flash_bwd_sep_plain(q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    shape = _check_sep(q, k, v)
    delta, do_ = _bwd_operands(o, lse, do, q.dtype, shape)
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous and on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    H = shape[2] * shape[3]
    _launch_split(
        flash_bwd_sep, q.data_ptr(), k.data_ptr(), v.data_ptr(), do_, lse,
        delta, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), H, H, shape,
        causal, sm_scale, q.dtype)
    return dq, dk, dv


def flash_fwd_sep(q, k, v, causal: bool, sm_scale: float):
    """K1 in its separate-input mode: (o, lse [B, h, S] fp32) of q, k, v
    [B, S, h, d]. Counts its CUDA launches in ``flash_fwd_sep.launches``."""
    if q.device.type == "cpu":
        return flash_sep_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, h, d = _check_sep(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, h, S), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    sched = sched_scratch(q, stream)
    variant = _launch(
        _kernel("flash_fwd_sep"), "flash_fwd_sep", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, h, d, int(causal),
        float(sm_scale), _DTYPE_CODE[q.dtype], sched.data_ptr(), stream)
    _count(flash_fwd_sep, (B, S, h, d), q.dtype, "fwd", variant)
    return o, lse


def _check_sep(q, k, v, head_major: bool = False
               ) -> tuple[int, int, int, int]:
    """The separate-input kernels' operand rules (shared with K11 and,
    head-major [B, h, S, d], K17); returns (B, S, h, d)."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype} / k {k.dtype} / v {v.dtype}: the "
                        "kernels take float32 or bfloat16, all alike")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want three "
                         + ("[B, h, S, d]" if head_major else "[B, S, h, d]"))
    B, S, h, d = q.shape
    if head_major:
        S, h = h, S
    if d not in SUPPORTED_HEAD_DIMS or S % 64:
        raise ValueError(f"head dim {d} / seq {S}: the kernels take d in "
                         f"{SUPPORTED_HEAD_DIMS} and S % 64 == 0")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q, k, v must be contiguous and on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: operands "
                             "must be 16-byte aligned")
    return B, S, h, d


def flash_fwd_hm(q, k, v, causal: bool, sm_scale: float):
    """K17 forward: (o [B, h, S, d], lse [B, h, S] fp32) of head-major q,
    k, v. Counts its CUDA launches in ``flash_fwd_hm.launches``."""
    if q.device.type == "cpu":
        return flash_fwd_hm_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, h, d = _check_sep(q, k, v, head_major=True)
    o = torch.empty_like(q)
    lse = torch.empty((B, h, S), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    sched = sched_scratch(q, stream)
    variant = _launch(
        _kernel("flash_fwd_hm"), "flash_fwd_hm", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, h, d, int(causal),
        float(sm_scale), _DTYPE_CODE[q.dtype], sched.data_ptr(), stream)
    _count(flash_fwd_hm, (B, S, h, d), q.dtype, "fwd", variant)
    return o, lse


def flash_bwd_hm(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """K17 backward, the dq then the dk/dv kernel: (dq, dk, dv)
    [B, h, S, d] of head-major operands (do cast to q's dtype, delta from
    the fp32 do * o). Counts its CUDA launches (two a call) in
    ``flash_bwd_hm.launches``."""
    if q.device.type == "cpu":
        return flash_bwd_hm_plain(q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    shape = _check_sep(q, k, v, head_major=True)
    delta, do_ = _bwd_operands(o, lse, do, q.dtype, shape, head_major=True)
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous and on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    tail = (*shape, int(causal), float(sm_scale), _DTYPE_CODE[q.dtype],
            _stream(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do_.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    variant = _launch(_kernel("flash_bwd_hm_dq"), "flash_bwd_hm_dq", *ins,
                      dq.data_ptr(), *tail)
    _count(flash_bwd_hm, shape, q.dtype, "dq", variant)
    variant = _launch(_kernel("flash_bwd_hm_dkv"), "flash_bwd_hm_dkv", *ins,
                      dk.data_ptr(), dv.data_ptr(), *tail)
    _count(flash_bwd_hm, shape, q.dtype, "dkv", variant)
    return dq, dk, dv


for _entry in (flash_fwd, flash_bwd, flash_fwd_sep, flash_bwd_split,
               flash_bwd_sep, flash_fwd_hm, flash_bwd_hm):
    _entry.launches = _entry.launches_wgmma = _entry.launches_fma = 0


# The fused-qkv entry is a pair of registered operators, so that the
# fusion compiler's trace (torch.fx make_fx) records each as one node on
# any device: the fake implementations give shapes only, the real ones
# are the wrappers above (plain version on the CPU, K1/K2/K3 on CUDA).

@torch.library.custom_op("paddle_tpu_torch::flash_qkv_fwd", mutates_args=())
def _flash_qkv_fwd_op(qkv: torch.Tensor, n_heads: int, causal: bool,
                      sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    # contiguous, as the fake implementation says: a trace turns the
    # caller's reshape of o into a view
    o, lse = flash_fwd(qkv, n_heads, causal, sm_scale)
    return o.contiguous(), lse.contiguous()


@_flash_qkv_fwd_op.register_fake
def _(qkv, n_heads, causal, sm_scale):
    B, S, H3 = qkv.shape
    d = H3 // (3 * n_heads)
    return (qkv.new_empty((B, S, n_heads, d)),
            qkv.new_empty((B, n_heads, S), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_qkv_bwd", mutates_args=())
def _flash_qkv_bwd_op(qkv: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor, n_heads: int, causal: bool,
                      sm_scale: float, merged: bool) -> torch.Tensor:
    bwd = flash_bwd if merged else flash_bwd_split
    return bwd(qkv, o, lse, do, n_heads, causal, sm_scale)


@_flash_qkv_bwd_op.register_fake
def _(qkv, o, lse, do, n_heads, causal, sm_scale, merged):
    return torch.empty_like(qkv)


def _flash_qkv_setup(ctx, inputs, output):
    qkv, n_heads, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(qkv, o, lse)
    ctx.args = (n_heads, causal, sm_scale)
    ctx.mark_non_differentiable(lse)


def _flash_qkv_backward(ctx, do, _dlse):
    """K2 when the flag is on and the reference's gate holds, else K3:
    the reference's choice, read when the backward runs."""
    qkv, o, lse = ctx.saved_tensors
    n_heads = ctx.args[0]
    d = qkv.shape[-1] // (3 * n_heads)
    hd = _heads_per_program(n_heads, d) * d
    merged = bool(GLOBAL_FLAGS.get("flash_attention_fused_dqkv")) and \
        fused_dqkv_ok(qkv.shape[1], hd, qkv.element_size())
    BWD_ROUTES["merged" if merged else "split"] += 1
    return (_flash_qkv_bwd_op(qkv, o, lse, do, *ctx.args, merged), None,
            None, None)


_flash_qkv_fwd_op.register_autograd(_flash_qkv_backward,
                                    setup_context=_flash_qkv_setup)


def flash_attention_qkv(qkv, n_heads: int, causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Differentiable attention straight from the fused qkv projection:
    [B, S, 3*h*d] -> [B, S, h, d]; K1 forward, K2 or K3 backward."""
    if not flash_qkv_supported(qkv.shape, n_heads, qkv.dtype):
        raise ValueError(f"flash_attention_qkv: shape {tuple(qkv.shape)} "
                         f"{qkv.dtype} with {n_heads} heads is not supported")
    d = qkv.shape[-1] // (3 * n_heads)
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    return _flash_qkv_fwd_op(qkv.contiguous(), n_heads, bool(causal),
                             float(scale))[0]


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_sep", mutates_args=())
def _flash_sep_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    RAW_ROUTES["native"] += 1
    o, lse = flash_fwd_sep(q, k, v, causal, sm_scale)
    return o.contiguous(), lse.contiguous()


@_flash_sep_op.register_fake
def _(q, k, v, causal, sm_scale):
    B, S, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, h, S), dtype=torch.float32))


def _flash_sep_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (causal, sm_scale)
    ctx.mark_non_differentiable(lse)


def _flash_sep_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    return (*flash_bwd_sep(q, k, v, o, lse, do, *ctx.args), None, None)


_flash_sep_op.register_autograd(_flash_sep_backward,
                                setup_context=_flash_sep_setup)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_hm", mutates_args=())
def _flash_hm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, sm_scale: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    RAW_ROUTES["head_major"] += 1
    o, lse = flash_fwd_hm(q, k, v, causal, sm_scale)
    return o.contiguous(), lse.contiguous()


@_flash_hm_op.register_fake
def _(q, k, v, causal, sm_scale):
    B, h, S, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, h, S), dtype=torch.float32))


def _flash_hm_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    return (*flash_bwd_hm(q, k, v, o, lse, do, *ctx.args), None, None)


# the setup is the separate entry's: both save q, k, v, o and lse
_flash_hm_op.register_autograd(_flash_hm_backward,
                               setup_context=_flash_sep_setup)


def flash_attention_raw(q, k, v, causal: bool = False,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Differentiable attention on separate q, k, v [B, S, h, d]. In the
    native layout K1's separate-input mode forward and K3's separate
    mode backward; with ``flash_attention_native_layout`` off, or where
    ``_native_supported`` fails, the head-major K17 on the transposed
    operands, o transposed back (the reference's ``swapaxes``). Plain
    versions on the CPU."""
    if not flash_supported(q.shape, q.dtype):
        raise ValueError(f"flash_attention_raw: shape {tuple(q.shape)} "
                         f"{q.dtype} is not supported")
    _, _, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    if GLOBAL_FLAGS.get("flash_attention_native_layout") and \
            _native_supported(h, d):
        return _flash_sep_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             bool(causal), float(scale))[0]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return _flash_hm_op(qt, kt, vt, bool(causal), float(scale))[0] \
        .transpose(1, 2)
