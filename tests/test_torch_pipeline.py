"""The port's pipeline against the JAX reference's, over gloo ranks
started by the port's launcher (tests/torch_sharded_worker.py), the
reference on the fake CPU devices with its compiler off.

- ``pipeline_blocks_fn`` alone at pp 2 M 4 and pp 4 M 2, both
  schedules, on tests/test_pipeline_1f1b.py's ``_stage_fn`` config: the
  reference path is ``jax.value_and_grad(loss_fn(..., blocks_fn=
  pipeline_blocks_fn(...)))`` (which runs here: only the reference's
  dense side needs its compiler) for the loss and every gradient, and
  ``jax.vjp`` of its blocks_fn on the embedding's output x0, from the
  cotangent of the loss after the blocks (final LayerNorm, tied head,
  cross-entropy), for the output and the gradients of the blocks and of
  x. The port's blocks_fn runs as a function (the same loss after it,
  and inside its own ``loss_fn``) and as the host-driven schedule with
  that loss as a per-microbatch tail, where "1f1b" must stash at most
  S - s inputs a rank and "gpipe" M.

(The pipelined train step is in tests/test_torch_pipeline_step.py.)

fp32 values are held to rtol 1e-5 against the reference, with an
absolute floor of 1e-5 of the tensor's largest magnitude (an element
whose value is rounding noise of a sum that cancels has no relative
precision in either package).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_sharded_common as C

PIPE_CFG = dict(vocab_size=128, hidden=64, n_layers=4, n_heads=2,
                seq_len=16, use_flash=False, remat=False)
PIPES = [dict(name=f"pipe_pp{pp}_m{m}_{sch}", kind="pipeline", pp=pp, M=m,
              schedule=sch, cfg=PIPE_CFG)
         for pp, m in ((2, 4), (4, 2)) for sch in ("1f1b", "gpipe")]

def _jcfg():
    from paddle_tpu.models.gpt import GPTConfig

    return GPTConfig(**PIPE_CFG, dtype=jnp.float32)


def _stage_fn(sp, x):
    from jax import lax

    from paddle_tpu.models.gpt import block_apply

    cfg = _jcfg()

    def body(c, bp):
        return block_apply(bp, c, cfg), None

    out, _ = lax.scan(body, x, sp)
    return out


def _prepare_pipe(case, root):
    """The inputs (the reference's weights and batch and the embedding's
    output x0) to ``<name>.in.npz``; returns the reference's side."""
    from paddle_tpu.distributed.process_mesh import build_mesh
    from paddle_tpu.models.gpt import (_chunked_ce, _layer_norm,
                                       init_params, loss_fn)
    from paddle_tpu.parallel.pipeline import pipeline_blocks_fn

    cfg = _jcfg()
    params = init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 128, size=(8, 16)).astype(np.int32)
    labs = rng.randint(0, 128, size=(8, 16)).astype(np.int32)
    x0 = params["wte"][toks] + params["wpe"][:16]
    np.savez(os.path.join(root, f"{case['name']}.in.npz"), tokens=toks,
             labels=labs, x0=np.asarray(x0),
             **C.pack(params, "params", {}))

    def reference():
        mesh = build_mesh((1, case["pp"], 1), ("dp", "pp", "mp"))
        bfn = pipeline_blocks_fn(_stage_fn, mesh, case["M"],
                                 schedule=case["schedule"])

        def tail(y):
            h = _layer_norm(y, params["lnf_g"], params["lnf_b"], cfg.eps)
            return _chunked_ce(h, params["wte"].T, labs, 512)

        with jax.sharding.set_mesh(mesh):
            y, vjp = jax.vjp(bfn, params["blocks"], x0)
            gb, gx = vjp(jax.grad(tail)(y))
            loss, g = jax.value_and_grad(
                lambda p: loss_fn(p, toks, labs, cfg, blocks_fn=bfn))(params)
        g = jax.tree.map(np.asarray, g)
        return dict(y=np.asarray(y), gx=np.asarray(gx),
                    gb=jax.tree.map(np.asarray, gb), loss=float(loss), g=g)

    return reference


def _runs(tmp_path_factory, tag, cases, nprocs):
    root = str(tmp_path_factory.mktemp(tag))
    return root, C.run_all(root, cases, nprocs=nprocs, prepare=_prepare_pipe)


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return _runs(tmp_path_factory, "pp2", [p for p in PIPES if p["pp"] == 2],
                 2)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _runs(tmp_path_factory, "pp4", [p for p in PIPES if p["pp"] == 4],
                 4)


def _runs_of(request, n):
    return request.getfixturevalue(f"runs{n}")


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    floor = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-5, atol=floor, err_msg=what)


def _slice(a, pp, s):
    k = a.shape[0] // pp
    return a[s * k:(s + 1) * k]


@pytest.mark.parametrize("case", PIPES, ids=[p["name"] for p in PIPES])
def test_pipeline_function_matches_the_reference(request, case):
    """Output, loss and every gradient of the blocks_fn as a function:
    of the blocks and x under the loss after the blocks, and inside
    loss_fn (all parameters)."""
    pp = case["pp"]
    root, results = _runs_of(request, pp)
    ref = results[case["name"]]
    for s in range(pp):
        got = np.load(os.path.join(root, f"{case['name']}.r{s}.npz"))
        _close(got["y"], ref["y"], f"y rank {s}")
        _close(got["gx"], ref["gx"], f"gx rank {s}")
        for k, v in ref["gb"].items():
            _close(got[f"gb/{k}"], _slice(v, pp, s), f"gb {k} rank {s}")
        np.testing.assert_allclose(float(got["loss"]), ref["loss"],
                                   rtol=1e-5)
        for k, v in ref["g"].items():
            if k == "blocks":
                for kk, vv in v.items():
                    _close(got[f"g/blocks/{kk}"], _slice(vv, pp, s),
                           f"g blocks/{kk} rank {s}")
            else:
                _close(got[f"g/{k}"], v, f"g {k} rank {s}")


@pytest.mark.parametrize("case", PIPES, ids=[p["name"] for p in PIPES])
def test_pipeline_schedule_matches_the_reference(request, case):
    """The host-driven schedule with a per-microbatch tail: the blocks'
    gradients and x's (stage 0) equal the reference's vjp; "1f1b"
    stashes at most S - s stage inputs on stage s, "gpipe" M."""
    pp, M = case["pp"], case["M"]
    root, results = _runs_of(request, pp)
    ref = results[case["name"]]
    for s in range(pp):
        got = np.load(os.path.join(root, f"{case['name']}.r{s}.npz"))
        for k, v in ref["gb"].items():
            _close(got[f"run/gb/{k}"], _slice(v, pp, s),
                   f"run gb {k} rank {s}")
        if s == 0:
            _close(got["run/gx"], ref["gx"], "run gx")
        else:
            assert "run/gx" not in got.files
        want = min(pp - s, M) if case["schedule"] == "1f1b" else M
        assert int(got["run/peak_stash"]) == want, (s, got["run/peak_stash"])
