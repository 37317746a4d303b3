"""The port's placement rules against the reference's (one process, no
group: the port's mesh is built for its shape): ``sanitize_spec``,
``shard_spec_over``, the Megatron parameter specs of the GPT and the
ZeRO-1 placement of every AdamW leaf (fp32, bf16 and int8 moments, fp32
masters), each equal to the ``.sharding.spec`` of the arrays the
reference's ``make_sharded_train_step`` returns, on the meshes (1,1,1),
(2,1,1), (4,1,1), (1,1,2), (2,1,2) and (2,1,4), dense with a tied head
and MoE with an untied one; and the placement <-> DTensor placements
round trip."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import placement as jpl
from paddle_tpu.distributed import process_mesh as jpm
from paddle_tpu.distributed import sharding as jsh
from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import train_step as jts
from paddle_tpu_torch.distributed import placement as tpl
from paddle_tpu_torch.distributed import process_mesh as tpm
from paddle_tpu_torch.distributed import sharding as tsh
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.parallel import train_step as tts

MESHES = [(1, 1, 1), (2, 1, 1), (4, 1, 1), (1, 1, 2), (2, 1, 2), (2, 1, 4)]
NAMES = ("dp", "pp", "mp")
CFG = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, seq_len=16,
           use_flash=False, remat=False)
VARIANTS = {"dense": dict(), "moe_untied": dict(n_experts=4, n_moe_layers=1,
                                                 tie_embeddings=False)}
MOMENTS = [(None, None), ("bfloat16", "bfloat16"), ("int8", "bfloat16")]


def _norm(spec, ndim: int) -> tuple:
    spec = tuple(spec) if spec is not None else ()
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        out.append(None if not e else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _jspec(a) -> tuple:
    s = a.sharding
    return _norm(s.spec if isinstance(s, NamedSharding) else None, a.ndim)


@pytest.mark.parametrize("shape", MESHES)
def test_sanitize_and_zero_specs_match(shape):
    jm = jpm.build_mesh(shape, NAMES)
    tm = tpm.build_mesh(shape, NAMES)
    specs = [(), ("mp",), (None, "mp"), ("dp", None), (("dp", "mp"),),
             ("pp", None, "mp"), (None, "dp", "mp"), ("mp", "dp")]
    shapes = [(8,), (6, 4), (4, 6, 8), (2, 3, 5), (16, 16, 16), (0,),
              (2048, 7), (1, 64, 192)]
    for spec in specs:
        for sh in shapes:
            if len(spec) > len(sh):
                continue
            want = jpl.sanitize_spec(JP(*spec), sh, jm)
            got = tpl.sanitize_spec(tpl.P(*spec), sh, tm)
            assert _norm(got, len(sh)) == _norm(want, len(sh)), (spec, sh)
            for cur in (None, want):
                jz = jsh.shard_spec_over(sh, cur, jm, "dp")
                tz = tsh.shard_spec_over(sh, None if cur is None else got,
                                         tm, "dp")
                assert (jz is None) == (tz is None), (spec, sh, cur)
                if jz is not None:
                    assert _norm(tz, len(sh)) == _norm(jz, len(sh))


def _port_state(tc, m_dtype, v_dtype):
    params = tg.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    low = tc.param_dtype != tc.dtype
    state = tts.adamw_init(params, master_weights=low, m_dtype=m_dtype,
                           v_dtype=v_dtype)
    if low:
        params = tts._tree_map(
            lambda a: a.to(tc.dtype) if a.dim() >= 2 else a, params)
    return params, state


def _pairs(jtree, ttree, specs):
    """(path, reference array, port leaf, port spec) of every tensor."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = _sorted_leaves(ttree)
    sl = _sorted_leaves(specs)
    assert len(jl) == len(tl) == len(sl)
    return [(jax.tree_util.keystr(p), a, t, s)
            for (p, a), t, s in zip(jl, tl, sl)]


def _sorted_leaves(tree):
    """Leaves in key order, as JAX flattens a dict (a spec is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_and_zero1_placements_match(shape, variant):
    jm = jpm.build_mesh(shape, NAMES)
    tm = tpm.build_mesh(shape, NAMES)
    kw = dict(CFG, **VARIANTS[variant])
    jc = jg.GPTConfig(**kw, dtype=jnp.bfloat16)
    tc = tg.GPTConfig(**kw, dtype=torch.bfloat16)
    for (m_dtype, v_dtype), zero1 in zip(MOMENTS + [(None, None)],
                                         [True, True, True, False]):
        _, jp, js = jts.make_sharded_train_step(jc, jm, zero1=zero1,
                                                m_dtype=m_dtype,
                                                v_dtype=v_dtype)
        tp, ts = _port_state(tc, m_dtype, v_dtype)
        pspecs = tts.gpt_param_specs(tc)
        for path, a, t, _ in _pairs(jp, tp, pspecs):
            assert tuple(t.shape) == a.shape and str(t.dtype).endswith(
                str(a.dtype)), path
        for name, a, t, s in _pairs(jp, tp, pspecs):
            got = _norm(tpl.sanitize_spec(s, t.shape, tm), t.dim())
            assert got == _jspec(a), (name, got, _jspec(a))
        ospecs = tts.opt_state_specs(ts, tc, tm, zero1)
        for name, a, t, s in _pairs(js, ts, ospecs):
            assert tuple(t.shape) == a.shape, name
            assert _norm(s, t.dim()) == _jspec(a), (
                m_dtype, zero1, name, s, _jspec(a))


def test_placements_round_trip():
    tm = tpm.build_mesh((2, 1, 4), NAMES)
    for spec in [tpl.P(), tpl.P("mp", None), tpl.P(None, "dp", "mp"),
                 tpl.P("mp", "dp")]:
        pl = tpl.to_placements(spec, tm, 3)
        assert len(pl) == 3
        assert _norm(tpl.to_partition_spec(pl, NAMES, 3), 3) == \
            _norm(spec, 3)
        mine = [tpl.Shard(p.dim) if p.is_shard() else tpl.Replicate()
                for p in pl]
        assert _norm(tpl.to_partition_spec(mine, NAMES, 3), 3) == \
            _norm(spec, 3)
    assert tpl.Shard(1) == tpl.Shard(1) and tpl.Partial() != tpl.Replicate()
    assert tm.coords(5) == {"dp": 1, "pp": 0, "mp": 1}
    assert tm.group("pp") is None
    pm = tpm.ProcessMesh(tm)
    assert pm.shape == [2, 1, 4] and pm.process_ids == list(range(8))
    assert pm.get_mesh_with_dim("mp").dim_names == ["mp", "dp", "pp"]
