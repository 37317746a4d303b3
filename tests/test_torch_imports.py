"""The PyTorch port stands alone: every module of ``paddle_tpu_torch``
and ``chip_smoke.py`` import with ``jax`` and ``paddle_tpu`` blocked, and
the entry points never drop to the CPU on their own."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "paddle_tpu"):
    sys.modules[name] = None
import paddle_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                             "paddle_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(" ".join(mods))
print(len(mods))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 112
    mods = set(out.stdout.split()[:-1])
    assert {"paddle_tpu_torch.compiler", "paddle_tpu_torch.compiler.catalog",
            "paddle_tpu_torch.compiler.fusion_pass",
            "paddle_tpu_torch.ops.kernels.fused_norm_epilogue",
            "paddle_tpu_torch.ops.kernels.fused_bias_act",
            "paddle_tpu_torch.ops.kernels.decode_attention",
            "paddle_tpu_torch.ops.kernels.fused_rope_attention",
            "paddle_tpu_torch.models.llama",
            "paddle_tpu_torch.ops.kernels.lora_matmul",
            "paddle_tpu_torch.inference.speculative",
            "paddle_tpu_torch.inference.multitenant.lora",
            "paddle_tpu_torch.inference.multitenant.constrain",
            "paddle_tpu_torch.incubate",
            "paddle_tpu_torch.incubate.nn",
            "paddle_tpu_torch.incubate.nn.functional",
            "paddle_tpu_torch.incubate.nn.functional.fused_transformer",
            "paddle_tpu_torch.obs", "paddle_tpu_torch.obs.trace",
            "paddle_tpu_torch.obs.flight", "paddle_tpu_torch.obs.metrics",
            "paddle_tpu_torch.testing", "paddle_tpu_torch.testing.chaos",
            "paddle_tpu_torch.inference.fleet",
            "paddle_tpu_torch.inference.fleet.router",
            "paddle_tpu_torch.inference.fleet.migration",
            "paddle_tpu_torch.inference.loadgen",
            "paddle_tpu_torch.inference.loadgen.arrivals",
            "paddle_tpu_torch.inference.loadgen.workload",
            "paddle_tpu_torch.inference.loadgen.metrics",
            "paddle_tpu_torch.inference.loadgen.driver",
            "paddle_tpu_torch.inference.fleet.rollout",
            "paddle_tpu_torch.distributed",
            "paddle_tpu_torch.distributed.store",
            "paddle_tpu_torch.distributed.checkpoint",
            "paddle_tpu_torch.distributed.comm_watchdog",
            "paddle_tpu_torch.distributed.launch",
            "paddle_tpu_torch.distributed.fleet",
            "paddle_tpu_torch.distributed.fleet.elastic",
            "paddle_tpu_torch.parallel.resilient_loop",
            "paddle_tpu_torch.parallel.resilient_step",
            "paddle_tpu_torch.distributed.placement",
            "paddle_tpu_torch.distributed.process_mesh",
            "paddle_tpu_torch.distributed.sharding",
            "paddle_tpu_torch.distributed.autograd_collectives",
            "paddle_tpu_torch.parallel.train_step",
            "paddle_tpu_torch.parallel.pipeline",
            "paddle_tpu_torch.parallel.ring_attention",
            "paddle_tpu_torch.distributed.topology",
            "paddle_tpu_torch.distributed.collective",
            "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.random",
            "paddle_tpu_torch.core.tensor", "paddle_tpu_torch.core.autograd",
            "paddle_tpu_torch.core.dispatch",
            "paddle_tpu_torch.ops.creation", "paddle_tpu_torch.ops.math",
            "paddle_tpu_torch.ops.manipulation",
            "paddle_tpu_torch.ops.method_table",
            "paddle_tpu_torch.nn", "paddle_tpu_torch.nn.layer.layers",
            "paddle_tpu_torch.nn.initializer",
            "paddle_tpu_torch.nn.functional",
            "paddle_tpu_torch.nn.functional.attention",
            "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.optimizer",
            "paddle_tpu_torch.optimizer.optimizer",
            "paddle_tpu_torch.optimizer.optimizers",
            "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.amp",
            "paddle_tpu_torch.nn.functional.activation",
            "paddle_tpu_torch.nn.functional.common",
            "paddle_tpu_torch.nn.functional.input",
            "paddle_tpu_torch.nn.functional.norm",
            "paddle_tpu_torch.nn.functional.loss",
            "paddle_tpu_torch.nn.layer.activation",
            "paddle_tpu_torch.nn.layer.common",
            "paddle_tpu_torch.nn.layer.container",
            "paddle_tpu_torch.nn.layer.norm",
            "paddle_tpu_torch.nn.layer.loss",
            "paddle_tpu_torch.nn.layer.transformer",
            "paddle_tpu_torch.nn.utils", "paddle_tpu_torch.models.bert",
            "paddle_tpu_torch.distributed.parallel",
            "paddle_tpu_torch.distributed.fleet.mp_layers",
            "paddle_tpu_torch.distributed.fleet.random",
            "paddle_tpu_torch.distributed.fleet.recompute",
            "paddle_tpu_torch.distributed.fleet.sequence_parallel_utils",
            "paddle_tpu_torch.distributed.fleet.hybrid_parallel_optimizer",
            "paddle_tpu_torch.distributed.fleet.meta_parallel",
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "tensor_parallel",
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "segment_parallel",
            } <= mods


_BLOCKED_ALL = _BLOCKED.replace('("jax", "jaxlib", "paddle_tpu")',
                               '("jax", "jaxlib", "paddle_tpu", "ml_dtypes")')
_BLOCKED_ALL = _BLOCKED_ALL.replace('in ("jax", "paddle_tpu")',
                                    'in ("jax", "paddle_tpu", "ml_dtypes")')

_API_MODULES = {"paddle_tpu_torch.autograd", "paddle_tpu_torch.framework",
             "paddle_tpu_torch.version", "paddle_tpu_torch.vision",
             "paddle_tpu_torch.vision.models",
             "paddle_tpu_torch.vision.models.resnet",
             "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.weights",
             "paddle_tpu_torch.nn.functional.conv",
             "paddle_tpu_torch.nn.functional.pooling",
             "paddle_tpu_torch.nn.functional.vision",
             "paddle_tpu_torch.nn.layer.conv",
             "paddle_tpu_torch.nn.layer.pooling",
             "paddle_tpu_torch.nn.layer.rnn",
             "paddle_tpu_torch.nn.layer.extra"}


def test_port_imports_without_jax_reference_or_ml_dtypes():
    """Every module, the autograd / nn conv, pooling, vision, rnn, extra
    / framework / vision ones among them, imports with ``ml_dtypes``
    blocked too (the card's host has none)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert _API_MODULES <= set(out.stdout.split()[:-1])


def test_namespaces_are_the_references():
    """``nn`` and ``nn.functional`` hold every public name of the
    reference's; the top level has autograd, framework, save, load,
    in_dynamic_mode, version and vision."""
    import paddle_tpu as ref
    import paddle_tpu.nn  # noqa: F401
    import paddle_tpu_torch as port

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert public(ref.nn) - public(port.nn) == set()
    assert public(ref.nn.functional) - public(port.nn.functional) == set()
    for name in ("autograd", "framework", "save", "load",
                 "in_dynamic_mode", "version", "vision"):
        assert getattr(port, name) is not None, name
        assert hasattr(ref, name), name
    assert port.__version__ == ref.__version__


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, hidden=32, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_hidden=48, max_seq_len=64,
                      dtype=torch.float32, param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device=.cpu."):
        ServingEngine(cfg, max_batch=1, page_size=16)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_llama_engine_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=64, hidden=256, n_layers=1, n_heads=2,
                      n_kv_heads=1, ffn_hidden=256, max_seq_len=256,
                      dtype=torch.float32, param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device=.cpu."):
        LlamaForCausalLM(cfg)
    m = LlamaForCausalLM(cfg, device="cpu")
    assert m.params["wte"].device.type == "cpu"


def test_training_entry_points_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.parallel.train_step import make_train_step

    cfg = GPTConfig(vocab_size=64, hidden=128, n_layers=1, n_heads=2,
                    seq_len=128)
    with pytest.raises(RuntimeError, match="device=.cpu."):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device=.cpu."):
        make_train_step(cfg, weights="sr-bf16")
    step, params, _ = make_train_step(cfg, device="cpu")
    assert params["wte"].device.type == "cpu"


def test_split_flash_backward_does_not_fall_back():
    """K3's wrappers take their plain versions for CPU tensors only: any
    other device launches the kernel (CUDA) or raises."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, h, d = 1, 128, 2, 64
    meta = dict(device="meta")
    qkv = torch.empty((B, S, 3 * h * d), **meta)
    o, do = (torch.empty((B, S, h, d), **meta) for _ in range(2))
    lse = torch.empty((B, h, S), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_split(qkv, o, lse, do, h, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_sep(o, o, o, o, lse, do, True, 0.125)


def test_paged_and_head_major_kernels_do_not_fall_back():
    """K15, K14, K16 and K17 take their plain versions for CPU tensors
    only; a tensor elsewhere launches the kernel (CUDA) or raises, and a
    paged cache asked for no device needs a card."""
    from paddle_tpu_torch.incubate.nn.functional import fused_transformer
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    meta = dict(device="meta")
    q = torch.empty((2, 8, 128), **meta)
    pages = torch.empty((8, 8, 128, 128), **meta)
    table = torch.empty((2, 4), dtype=torch.int32, **meta)
    lens = torch.empty((2,), dtype=torch.int32, **meta)
    for fn in (da.paged_decode_attention_mxu,
               da.paged_decode_attention_kernel,
               da.paged_decode_attention_dma):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, pages, pages, table, lens, 0.125)
    t = torch.empty((1, 2, 128, 64), **meta)
    lse = torch.empty((1, 2, 128), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd_hm(t, t, t, True, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_hm(t, t, t, t, lse, t, True, 0.125)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=.cpu."):
            fused_transformer.PagedKVCache(8, 2, 16, 64, 2, 64)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: nonzero exit and no result line. Alone in a directory
    (without the package) it fails as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
