"""The port's self-healing training runtime against the JAX package's on
the CPU: the toy-loop cases of tests/test_chaos.py run through both
packages' ``ResilientTrainLoop`` with the same fault plan (armed in each
package's own chaos module), the same data and the same SGD step, and
must give the same step counters, ``stats`` and losses (the toy's fp32
losses within rtol 1e-5: the two backends' 4-term dot products may
round apart). Also the store's faults and retries, the local store's
timeout, barrier key reuse, dropped heartbeats, rank-targeted faults,
``agree_resume_step``, the flag defaults, and the end-to-end kill and
resume through the port's ``run_elastic`` with a port worker
(tests/torch_chaos_worker.py)."""

import os
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.parallel.resilient_loop import ResilientTrainLoop as JLoop
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as TFLAGS
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.distributed.comm_watchdog import (comm_task_manager,
                                                        watched_step)
from paddle_tpu_torch.distributed.fleet.elastic import (ELASTIC_EXIT_CODE,
                                                        ElasticManager,
                                                        run_elastic)
from paddle_tpu_torch.distributed.launch import launch_procs
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.parallel.resilient_loop import (ResilientTrainLoop,
                                                      agree_resume_step,
                                                      with_retries)
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_chaos_worker.py")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jchaos.disarm()
    tchaos.disarm()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _arm(*specs) -> None:
    """The same plan in both packages: specs are (point, kind, kw)."""
    for mod in (jchaos, tchaos):
        plan = mod.FaultPlan(seed=0)
        for point, kind, kw in specs:
            plan.add(point, kind, **kw)
        mod.arm(plan)


# -- the toy loop, in both packages -----------------------------------------

_rng = np.random.RandomState(0)
X = _rng.randn(8, 4).astype(np.float32)
Y = (X @ _rng.randn(4, 2)).astype(np.float32)


@jax.jit
def _jsgd(w, x, y):
    loss, g = jax.value_and_grad(lambda w: ((x @ w - y) ** 2).mean())(w)
    return loss, w - 0.05 * g


def _jstep(state, batch):
    loss, w = _jsgd(state["w"]._data, *batch)
    return loss, {"w": JTensor(w)}


def _tstep(state, batch):
    x, y = batch
    w = state["w"].detach().clone().requires_grad_(True)
    loss = ((x @ w - y) ** 2).mean()
    (g,) = torch.autograd.grad(loss, w)
    return loss.detach(), {"w": (w - 0.05 * g).detach()}


def _loops(tmp_path, **kw):
    """(JAX loop, port loop) over the toy problem, each with its own
    checkpoint directory. JAX's step is compiled here, outside the
    watchdog's guard of the first step."""
    _jsgd(jnp.zeros((4, 2), jnp.float32), X, Y)
    jl = JLoop(_jstep, {"w": JTensor(jnp.zeros((4, 2), jnp.float32))},
               str(tmp_path / "jck"), save_every=1, **kw)
    tl = ResilientTrainLoop(_tstep, {"w": torch.zeros(4, 2)},
                            str(tmp_path / "tck"), save_every=1, **kw)
    return jl, tl


_JB = (X, Y)
_TB = (torch.from_numpy(X), torch.from_numpy(Y))


def _step_both(jl, tl):
    """One guarded step in each loop; the outcomes must agree."""
    a, b = jl.run_step(_JB), tl.run_step(_TB)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_allclose(b, a, rtol=1e-5)
    assert (tl.step, tl.bad_streak, tl.stats) == \
        (jl.step, jl.bad_streak, jl.stats)
    np.testing.assert_allclose(tl.state["w"].numpy(),
                               jl.state["w"].numpy(), rtol=1e-5, atol=1e-7)
    return b


def test_nan_step_skipped_then_rolled_back(tmp_path):
    """train.step invocations 3 and 4 read NaN: skip, skip, rollback to
    the step-3 checkpoint, then on to step 6."""
    jl, tl = _loops(tmp_path, keep_last_k=3, max_bad_steps=2,
                    step_timeout=60.0)
    _arm(("train.step", "nan", dict(at=3)), ("train.step", "nan", dict(at=4)))
    losses = []
    while tl.step < 6:
        out = _step_both(jl, tl)
        if out is not None:
            losses.append(out)
    assert tl.stats["skipped"] == 2 and tl.stats["rollbacks"] == 1
    assert tl.step == jl.step == 6
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_rollback_restores_checkpointed_weights(tmp_path):
    jl, tl = _loops(tmp_path, keep_last_k=3, max_bad_steps=1,
                    step_timeout=60.0)
    for _ in range(3):
        _step_both(jl, tl)
    w3 = tl.state["w"].clone()
    _arm(("train.step", "nan", dict(at=0)))
    assert _step_both(jl, tl) is None
    assert tl.step == 3 and torch.equal(tl.state["w"], w3)


def test_donated_step_restores_on_every_bad_step(tmp_path):
    """donated_step: the skipped step's state is gone, so the sentinel
    restores at once, not after max_bad_steps."""
    jl, tl = _loops(tmp_path, keep_last_k=3, max_bad_steps=5,
                    step_timeout=60.0, donated_step=True)
    for _ in range(2):
        _step_both(jl, tl)
    _arm(("train.step", "nan", dict(at=0)))
    assert _step_both(jl, tl) is None
    assert tl.stats["rollbacks"] == 1 and tl.step == 2


def test_in_place_step_nan_lands_then_restores(tmp_path):
    """An in-place step (the port's AdamW) has overwritten the state when
    its loss reads NaN: with donated_step the loop restores the last
    checkpoint, so the state is the committed one again, bitwise."""
    def inplace(state, batch):
        x, y = batch
        w = state["w"]
        w.requires_grad_(True)
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            w.sub_(0.05 * g)
        return loss.detach(), state

    loop = ResilientTrainLoop(inplace, {"w": torch.zeros(4, 2)},
                              str(tmp_path / "ck"), save_every=1,
                              keep_last_k=2, donated_step=True)
    for _ in range(2):
        loop.run_step(_TB)
    w2 = loop.state["w"].detach().clone()
    tchaos.arm(tchaos.FaultPlan(seed=0).add("train.step", "nan", at=0))
    assert loop.run_step(_TB) is None
    assert loop.step == 2 and torch.equal(loop.state["w"].detach(), w2)


def test_hung_step_escalates_with_comm_dump_and_checkpoint(tmp_path):
    seen = {"j": [], "t": []}
    jl, tl = _loops(tmp_path, keep_last_k=3, max_bad_steps=3,
                    step_timeout=0.2)
    jl.on_escalate = lambda tag, age: seen["j"].append(tag)
    tl.on_escalate = lambda tag, age: seen["t"].append(tag)
    _step_both(jl, tl)
    comm_task_manager.enabled = True
    tid = comm_task_manager.register("allreduce(grads)")
    assert [n for n, _ in comm_task_manager.in_flight()] == \
        ["allreduce(grads)"]
    _arm(("train.step", "hang", dict(at=0, seconds=0.8)))
    t0 = time.monotonic()
    _step_both(jl, tl)
    assert time.monotonic() - t0 >= 0.4
    comm_task_manager.complete(tid)
    comm_task_manager.enabled = False
    assert seen["t"] == seen["j"] == ["step1"]
    assert tl.stats["hangs"] == 1
    target = {"w": torch.zeros(4, 2)}
    assert tck.load_latest_valid(target, str(tmp_path / "tck")) >= 1


def test_default_escalation_exits_with_elastic_code(tmp_path, monkeypatch):
    codes = []
    monkeypatch.setattr(os, "_exit", lambda c: codes.append(c))
    _, tl = _loops(tmp_path, keep_last_k=2, max_bad_steps=3,
                   step_timeout=0.15)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("train.step", "hang", at=0,
                                            seconds=0.6))
    tl.run_step(_TB)
    assert codes == [ELASTIC_EXIT_CODE] == [101]


def test_train_step_raise_and_exit_kinds(tmp_path, monkeypatch):
    _, tl = _loops(tmp_path, keep_last_k=2)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("train.step", "raise", at=0))
    with pytest.raises(tchaos.ChaosInjected, match="train step failure"):
        tl.run_step(_TB)
    codes = []
    monkeypatch.setattr(os, "_exit", lambda c: codes.append(c))
    tchaos.arm(tchaos.FaultPlan(seed=0).add("train.step", "exit", at=0,
                                            code=7))
    tl.run_step(_TB)
    assert codes == [7]


def test_watched_step_guards_and_returns(tmp_path):
    seen = []
    run = watched_step(lambda a: (a * 2, {"x": a}), timeout=0.1,
                       on_hang=lambda tag, age: seen.append(tag), tag="s")
    out = run(torch.ones(2))
    assert torch.equal(out[0], torch.full((2,), 2.0)) and not seen
    slow = watched_step(lambda: time.sleep(0.3), timeout=0.1,
                        on_hang=lambda tag, age: seen.append(tag), tag="s")
    slow()
    assert seen == ["s"] and slow.watchdog.hang_count == 1


# -- with_retries + flag-driven defaults ------------------------------------

def test_with_retries_deadline_bounded():
    calls = []

    def always_fails():
        calls.append(1)
        raise ConnectionError("down")

    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        with_retries(always_fails, retries=100, base_delay=0.05,
                     deadline=0.4, seed=0)
    assert time.monotonic() - t0 < 3.0 and len(calls) >= 2


def test_with_retries_gives_up_after_retries():
    calls = []

    def always_fails():
        calls.append(1)
        raise TimeoutError("nope")

    with pytest.raises(TimeoutError):
        with_retries(always_fails, retries=3, base_delay=0.001, seed=0)
    assert len(calls) == 4


def test_resilient_defaults_come_from_flags(tmp_path):
    """The five flags carry the reference's defaults and feed the loop."""
    names = ["resilient_max_bad_steps", "resilient_step_timeout",
             "resilient_keep_last_k", "resilient_retry_max",
             "resilient_retry_base_delay"]
    for n in names:
        assert TFLAGS.get(n) == JFLAGS.get(n), n
        assert type(TFLAGS.get(n)) is type(JFLAGS.get(n)), n
    assert [TFLAGS.get(n) for n in names] == [3, 120.0, 3, 5, 0.05]
    saved = {n: TFLAGS.get(n) for n in names}
    try:
        for n, v in (("resilient_max_bad_steps", 7),
                     ("resilient_keep_last_k", 11),
                     ("resilient_step_timeout", 33.0),
                     ("resilient_retry_max", 2)):
            TFLAGS.set(n, v)
        loop = ResilientTrainLoop(lambda s, b: (0.0, s), {},
                                  str(tmp_path / "ck"))
        assert (loop.max_bad_steps, loop.keep_last_k, loop.watchdog.timeout,
                loop.retries) == (7, 11, 33.0, 2)
    finally:
        for n, v in saved.items():
            TFLAGS.set(n, v)


# -- the store ----------------------------------------------------------------

def test_store_faults_and_retry_recovery():
    store = TCPStore("127.0.0.1", _free_port(), is_master=True,
                     world_size=1)
    store.set("k", b"v")
    assert store.get("k") == b"v" and store.add("n", 2) == 2
    tchaos.arm(tchaos.FaultPlan(seed=0).add("store.get", "timeout", at=0)
               .add("store.set", "flaky", at=0))
    with pytest.raises(TimeoutError):
        store.get("k")
    with_retries(store.set, "k2", b"w", retries=3, base_delay=0.01, seed=1)
    tchaos.disarm()
    assert store.get("k2") == b"w"
    store.wait(["k", "k2"])


def test_store_errors_map_to_the_retried_exceptions():
    """torch's store errors reach the caller as the exceptions
    with_retries retries: a get past the timeout as TimeoutError, a
    connection that cannot be made as ConnectionError."""
    port = _free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, world_size=1,
                     timeout=0.3)
    with pytest.raises(TimeoutError):
        store.get("never-set")
    client = TCPStore("127.0.0.1", port, world_size=2, timeout=5.0)
    client.set("c", "x")
    assert store.get("c") == b"x"
    with pytest.raises(ConnectionError):
        TCPStore("127.0.0.1", _free_port(), world_size=2, timeout=0.5)


def test_store_connect_refused_injected(monkeypatch):
    monkeypatch.setattr(tstore, "_torch_store_cls", lambda: None)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("store.connect", "refuse",
                                            at=0))
    with pytest.raises(ConnectionRefusedError):
        TCPStore("127.0.0.1", 1, is_master=True, world_size=1)


def test_local_store_get_honors_timeout(monkeypatch):
    """Without torch.distributed a one-process store is a dict whose get
    raises TimeoutError on a key nobody sets."""
    monkeypatch.setattr(tstore, "_torch_store_cls", lambda: None)
    store = TCPStore("127.0.0.1", 1, is_master=True, world_size=1,
                     timeout=0.2)
    assert store._local is not None
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        store.get("never-set")
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(RuntimeError):
        TCPStore("127.0.0.1", 1, is_master=True, world_size=2)


def test_barrier_key_reuse_regression():
    """A reused barrier key must not pass at once on the previous use's
    count; a timed-out partial count is abandoned."""
    store = TCPStore("127.0.0.1", _free_port(), is_master=True,
                     world_size=1)
    errs = []

    def arrive():
        try:
            store.barrier("b", 2, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    for _ in range(2):
        ts = [threading.Thread(target=arrive) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=15)
        assert not errs, errs
        if _ == 0:
            with pytest.raises(TimeoutError):
                store.barrier("b", 2, timeout=0.4)


def test_agree_resume_step_takes_fleet_minimum():
    store = TCPStore("127.0.0.1", _free_port(), is_master=True,
                     world_size=1)
    out = {}

    def publish(rank, step, tag):
        out[rank] = agree_resume_step(store, rank, 3, step, tag=tag,
                                      timeout=20.0)

    for tag, steps, want in (("t0", (7, 5, 9), 5),
                             ("t1", (7, None, 9), None)):
        out.clear()
        ts = [threading.Thread(target=publish, args=(r, s, tag))
              for r, s in enumerate(steps)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert out == {0: want, 1: want, 2: want}


def test_dropped_heartbeats_expire_lease():
    store = TCPStore("127.0.0.1", _free_port(), is_master=True,
                     world_size=1)
    tchaos.arm(tchaos.FaultPlan(seed=0).add("elastic.heartbeat", "drop",
                                            once=False))
    mgr = ElasticManager(host="nodeA", store=store, np=1, ttl=1.0,
                         heartbeat_interval=0.1)
    mgr.register()
    assert mgr.live_hosts() == []
    mgr.exit()
    tchaos.disarm()
    mgr._beat()
    assert mgr.live_hosts() == ["nodeA"]
    assert mgr._match() and mgr.endpoints(9000) == "nodeA:9000"


def test_rank_targeted_fault_filters_by_env_rank(monkeypatch):
    plan = tchaos.FaultPlan(seed=0).add("train.step", "exit", at=0, rank=1,
                                        code=7)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    tchaos.arm(plan)
    assert tchaos.fire("train.step") is None
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    tchaos.arm(plan)
    spec = tchaos.fire("train.step")
    assert spec is not None and spec.kind == "exit"
    assert spec.args == {"rank": 1, "code": 7}
    back = tchaos.FaultPlan.from_json(plan.to_json())
    assert back.faults[0].args == {"rank": 1, "code": 7}


# -- the launcher -------------------------------------------------------------

def test_launch_procs_stops_the_fleet_on_a_failure(tmp_path):
    """Rank 1 exits 3 at once; rank 0 would sleep for a minute: the
    launcher returns 3 and stops rank 0."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "r = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "print('rank', r, os.environ['PADDLE_TRAINERS_NUM'], flush=True)\n"
        "sys.exit(3) if r == 1 else time.sleep(60)\n")
    t0 = time.monotonic()
    rc = launch_procs(str(script), [], 2, log_dir=str(tmp_path / "logs"))
    assert rc == 3 and time.monotonic() - t0 < 30
    assert "rank 0 2" in (tmp_path / "logs" / "worker.0.log").read_text()


def test_launch_procs_joins_a_gloo_group(tmp_path):
    """Two ranks started by the launcher join one process group from its
    environment (``init_from_env``: gloo for the CPU) and all-reduce."""
    script = tmp_path / "w.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from paddle_tpu_torch.distributed.launch import init_from_env\n"
        "assert init_from_env(device='cpu')\n"
        "t = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "print('SUM', dist.get_rank(), dist.get_world_size(), t.item(),\n"
        "      flush=True)\n"
        "dist.destroy_process_group()\n")
    rc = launch_procs(str(script), [], 2, log_dir=str(tmp_path / "logs"),
                      timeout=120)
    assert rc == 0
    for r in (0, 1):
        log = (tmp_path / "logs" / f"worker.{r}.log").read_text()
        assert f"SUM {r} 2 3.0" in log, log


# -- end to end: kill a worker mid-run, resume from the last VALID checkpoint

def _logs(tmp_path, gens, ranks):
    out = {}
    for g in gens:
        for r in ranks:
            p = tmp_path / "logs" / f"restart_{g}" / f"worker.{r}.log"
            out[(g, r)] = p.read_text() if p.exists() else ""
    return out


def test_chaos_e2e_kill_resume_monotone(tmp_path):
    """Generation 0 tears its step-3 save, then dies on an injected step
    failure; the port's run_elastic relaunches, and the healed generation
    resumes at step 2 (step 3's checkpoint is torn) and trains to 8."""
    ckpt = str(tmp_path / "ckpt")
    plan = tchaos.FaultPlan(seed=0, name="e2e")
    plan.add("checkpoint.save", "torn", at=2)
    plan.add("train.step", "raise", at=3)
    rc = run_elastic(
        WORKER, [], nprocs=1, max_restarts=2,
        log_dir=str(tmp_path / "logs"),
        env_extra={"PYTHONPATH": REPO, "CHAOS_CKPT_DIR": ckpt,
                   "CHAOS_TOTAL_STEPS": "8", **plan.to_env()})
    assert rc == 0, rc
    logs = _logs(tmp_path, (0, 1), (0,))
    g0, g1 = logs[(0, 0)], logs[(1, 0)]
    assert "RESUMED step=-1" in g0
    assert "chaos: train step failure" in g0
    assert [int(s) for s in re.findall(r"STEP (\d+) ", g0)] == [1, 2, 3]
    assert "RESUMED step=2" in g1, g1
    assert [int(s) for s in re.findall(r"STEP (\d+) ", g1)] == \
        list(range(3, 9))
    assert "DONE step=8" in g1
    l0 = [float(x) for x in re.findall(r"LOSS ([\d.]+)", g0)]
    l1 = [float(x) for x in re.findall(r"LOSS ([\d.]+)", g1)]
    assert l1[-1] < l0[0]


@pytest.mark.slow
def test_chaos_multihost_rank_loss_resume(tmp_path):
    """Rank 1 of a 2-rank lockstep fleet vanishes mid-step; the launcher
    reaps the survivor, run_elastic relaunches, and the healed generation
    agrees on the victim's newest step and trains to completion."""
    ckpt = str(tmp_path / "ckpt")
    plan = tchaos.FaultPlan(seed=0, name="mh")
    plan.add("train.step", "exit", at=4, rank=1, code=7)
    rc = run_elastic(
        WORKER, [], nprocs=2, max_restarts=2,
        log_dir=str(tmp_path / "logs"),
        env_extra={"PYTHONPATH": REPO, "CHAOS_CKPT_DIR": ckpt,
                   "CHAOS_MULTIHOST": "1", "CHAOS_TOTAL_STEPS": "8",
                   **plan.to_env()})
    assert rc == 0, rc
    logs = _logs(tmp_path, (0, 1), (0, 1))
    assert "RESUMED agreed=-1 step=0" in logs[(0, 0)]
    assert "RESUMED agreed=-1 step=0" in logs[(0, 1)]
    g01 = [int(s) for s in re.findall(r"STEP (\d+) ", logs[(0, 1)])]
    assert g01 == [1, 2, 3, 4], logs[(0, 1)]
    g00 = [int(s) for s in re.findall(r"STEP (\d+) ", logs[(0, 0)])]
    assert g00[:4] == [1, 2, 3, 4] and len(g00) <= 5
    for r in (0, 1):
        assert "RESUMED agreed=4 step=4" in logs[(1, r)], logs[(1, r)]
        g1 = [int(s) for s in re.findall(r"STEP (\d+) ", logs[(1, r)])]
        assert g1 == [5, 6, 7, 8] and "DONE step=8" in logs[(1, r)]
