"""Self-healing training loop: retries, NaN sentinel, hang escalation,
auto-resume (the port's copy of paddle_tpu/parallel/resilient_loop.py).

- :func:`with_retries`: exponential backoff with full jitter around
  store and checkpoint IO, bounded by a deadline, so that a flaky store
  connection or a slow filesystem is survived;
- a NaN/Inf sentinel: a non-finite loss does not commit the step's
  state; after ``max_bad_steps`` poisoned steps in a row (or at once,
  with ``donated_step``) the loop rolls back to the newest checkpoint
  passing verification (``checkpoint.load_latest_valid``);
- a :class:`~paddle_tpu_torch.distributed.comm_watchdog.StepWatchdog`
  around every step's blocking region; on a hang it dumps the in-flight
  comm tasks, checkpoints the last good state and exits with
  ``ELASTIC_EXIT_CODE``, so that the elastic supervisor
  (``distributed.fleet.elastic.run_elastic``) relaunches the generation;
- auto-resume: :meth:`ResilientTrainLoop.resume` walks back from the
  newest checkpoint to the first valid one.

A step that updates its state in place (the port's ``make_train_step``:
AdamW writes params and moments in place) has already overwritten the
state when its loss turns out non-finite: such a loop must run with
``donated_step=True``, which restores from the last valid checkpoint on
every bad step (``parallel.resilient_step.make_resilient_loop`` does).

Defaults come from the ``resilient_*`` flags (core/flags.py). All of this
is host-side control flow around the step; the ``train.step`` chaos
point is a no-op unless a plan is armed.
"""

from __future__ import annotations

import logging
import math
import os
import random
import time
from typing import Callable, Optional

from .. import obs as _obs

__all__ = ["with_retries", "agree_resume_step", "ResilientTrainLoop"]

logger = logging.getLogger("paddle_tpu_torch.parallel.resilient_loop")

_RETRYABLE = (ConnectionError, TimeoutError, OSError)


def _flag_defaults() -> dict:
    from ..core.flags import GLOBAL_FLAGS

    return {n: GLOBAL_FLAGS.get(n) for n in (
        "resilient_max_bad_steps", "resilient_step_timeout",
        "resilient_keep_last_k", "resilient_retry_max",
        "resilient_retry_base_delay")}


def with_retries(fn: Callable, *args, retries: Optional[int] = None,
                 base_delay: Optional[float] = None, max_delay: float = 2.0,
                 deadline: Optional[float] = None,
                 retry_on: tuple = _RETRYABLE, seed: Optional[int] = None,
                 on_retry: Optional[Callable] = None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` exceptions with
    exponential backoff and full jitter (delay_i ~ U(0, min(max_delay,
    base_delay * 2**i))). ``deadline`` bounds total wall-clock seconds:
    once exceeded, the last exception propagates instead of sleeping
    again. ``retries`` counts re-attempts after the first call."""
    if retries is None or base_delay is None:
        defaults = _flag_defaults()
        if retries is None:
            retries = defaults["resilient_retry_max"]
        if base_delay is None:
            base_delay = defaults["resilient_retry_base_delay"]
    rng = random.Random(seed) if seed is not None else random
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            expired = deadline is not None and \
                time.monotonic() - t0 >= deadline
            if attempt > retries or expired:
                raise
            delay = rng.uniform(0.0, min(max_delay,
                                         base_delay * (2 ** (attempt - 1))))
            if deadline is not None:
                delay = min(delay, max(0.0,
                                       deadline - (time.monotonic() - t0)))
            logger.warning("retry %d/%d after %r (sleeping %.3fs)",
                           attempt, retries, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)


def agree_resume_step(store, rank: int, world_size: int,
                      local_step: Optional[int], *, tag: str = "resume",
                      timeout: float = 120.0) -> Optional[int]:
    """Fleet-wide resume agreement: every rank publishes the step of its
    newest VALID checkpoint and all adopt the minimum — after a rank loss
    the healed generation walks back to a step every survivor can
    actually load (a rank that died before its newest save, or whose save
    was torn, drags the whole fleet back with it). ``local_step=None``
    publishes -1; an agreed -1 means no rank has a usable checkpoint and
    the return is None (fresh start everywhere). ``tag`` must be unique
    per generation — barrier keys are reused across relaunches."""
    step = -1 if local_step is None else int(local_step)
    store.set(f"{tag}/step/{rank}", str(step))
    store.barrier(f"{tag}/published", world_size, timeout=timeout)
    agreed = min(int(store.get(f"{tag}/step/{r}").decode())
                 for r in range(world_size))
    return None if agreed < 0 else agreed


class ResilientTrainLoop:
    """Fault-tolerant driver around a train step.

    ``step_fn(state, batch) -> (loss, new_state)`` where ``state`` is a
    (possibly nested) dict of tensors — the checkpointable state_dict.
    The loop commits ``new_state`` only when the fetched loss is finite,
    checkpoints with rotation + integrity manifest, and recovers from
    the four fault classes (torn checkpoint, store/IO flake, NaN step,
    hung step) without losing the run::

        loop = ResilientTrainLoop(step_fn, state, ckpt_root)
        start = loop.resume()                  # None or resumed step
        while loop.step < total_steps:
            loss = loop.run_step(next(batches))   # None = skipped step

    ``on_escalate(tag, age_s)`` replaces the default hang escalation
    (checkpoint + ``os._exit(ELASTIC_EXIT_CODE)``) — tests use this to
    observe escalation in-process.

    ``donated_step=True``: the step consumes its state (it writes it in
    place, as the port's AdamW does), so after a *skipped* step the old
    state is gone and cannot be fed again — the sentinel then restores
    from the last valid checkpoint on **every** bad step instead of only
    after ``max_bad_steps``.
    """

    def __init__(self, step_fn: Callable, state: dict, ckpt_dir: str, *,
                 save_every: int = 1, keep_last_k: Optional[int] = None,
                 max_bad_steps: Optional[int] = None,
                 step_timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 on_escalate: Optional[Callable[[str, float], None]] = None,
                 donated_step: bool = False,
                 coordinator_rank: int = 0):
        from ..distributed.comm_watchdog import StepWatchdog

        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        defaults = _flag_defaults()
        self.save_every = max(1, int(save_every))
        self.keep_last_k = keep_last_k if keep_last_k is not None else \
            defaults["resilient_keep_last_k"]
        self.max_bad_steps = max_bad_steps if max_bad_steps is not None \
            else defaults["resilient_max_bad_steps"]
        self.retries = retries if retries is not None else \
            defaults["resilient_retry_max"]
        self.on_escalate = on_escalate
        self.donated_step = donated_step
        self.coordinator_rank = coordinator_rank
        timeout = step_timeout if step_timeout is not None else \
            defaults["resilient_step_timeout"]
        self.watchdog = StepWatchdog(timeout=timeout,
                                     on_hang=self._escalate)
        self.step = 0
        self.bad_streak = 0
        self.stats = {"skipped": 0, "rollbacks": 0, "hangs": 0,
                      "io_retries": 0}
        # FLAGS_obs_trace=1 arms the observability plane on the train
        # side too (train.step / ckpt.save spans, death-path dumps)
        _obs.arm_from_flags()

    # -- recovery ---------------------------------------------------------
    def resume(self) -> Optional[int]:
        """Load the newest checkpoint passing integrity verification;
        returns the resumed step (and sets the loop's counter) or None."""
        from ..distributed.checkpoint import load_latest_valid

        resumed = load_latest_valid(self.state, self.ckpt_dir)
        if resumed is not None:
            self.step = resumed
            logger.info("resumed from checkpoint step %d", resumed)
        return resumed

    def resume_fleet(self, store, rank: int, world_size: int, *,
                     tag: str = "resume",
                     timeout: float = 120.0) -> Optional[int]:
        """Multi-host resume: local newest-valid walk-back, then adopt
        the fleet-wide minimum (:func:`agree_resume_step`). A rank whose
        local history runs ahead of the agreement reloads at the agreed
        step, so every rank of the healed generation restarts from the
        SAME durable step. Returns the agreed step (None = fresh)."""
        local = self.resume()
        agreed = agree_resume_step(store, rank, world_size, local,
                                   tag=tag, timeout=timeout)
        if agreed is None:
            self.step = 0
            return None
        if agreed != local:    # min over ranks: agreed < local here
            from ..distributed.checkpoint import load_state_dict, step_dir

            with_retries(load_state_dict, self.state,
                         step_dir(self.ckpt_dir, agreed),
                         retries=self.retries, on_retry=self._count_retry)
            logger.warning("fleet agreement walked resume back from "
                           "step %s to %d", local, agreed)
        self.step = agreed
        return agreed

    def _rollback(self):
        from ..distributed.checkpoint import load_latest_valid

        _obs.flight_dump("nan-rollback",
                         detail=f"step {self.step}: {self.bad_streak} "
                                "consecutive non-finite loss(es)")
        rolled = with_retries(load_latest_valid, self.state, self.ckpt_dir,
                              retries=self.retries,
                              on_retry=self._count_retry)
        self.stats["rollbacks"] += 1
        self.bad_streak = 0
        if rolled is None:
            logger.error("rollback requested but no valid checkpoint under "
                         "%s; continuing from current state", self.ckpt_dir)
            return
        self.step = rolled
        logger.warning("rolled back to checkpoint step %d after "
                       "consecutive non-finite steps", rolled)

    def _count_retry(self, attempt, exc):
        self.stats["io_retries"] += 1

    def _save(self):
        from ..distributed.checkpoint import save_checkpoint

        with _obs.span("ckpt.save", step=self.step):
            with_retries(save_checkpoint, self.state, self.ckpt_dir,
                         self.step, keep_last_k=self.keep_last_k,
                         coordinator_rank=self.coordinator_rank,
                         retries=self.retries,
                         on_retry=self._count_retry)

    # -- hang escalation --------------------------------------------------
    def _escalate(self, tag: str, age: float):
        """dump in-flight comm tasks -> checkpoint last good state ->
        ELASTIC_EXIT_CODE (the supervisor relaunches the generation)."""
        from ..distributed.comm_watchdog import comm_task_manager

        self.stats["hangs"] += 1
        tasks = comm_task_manager.in_flight()
        _obs.flight_dump("watchdog-escalation",
                         detail=f"{tag} hung {age:.1f}s; "
                                f"{len(tasks)} in-flight comm task(s)")
        logger.error("step %r hung for %.1fs; %d in-flight comm task(s)%s",
                     tag, age, len(tasks),
                     "".join(f"\n  - {n} ({a:.1f}s old)" for n, a in tasks))
        try:
            self._save()   # last committed (good) state, durable
        except Exception as e:  # noqa: BLE001 — escalation must not throw
            logger.error("emergency checkpoint failed: %r", e)
        if self.on_escalate is not None:
            self.on_escalate(tag, age)
            return
        from ..distributed.fleet.elastic import ELASTIC_EXIT_CODE

        # os._exit: the main thread is wedged inside the step; a normal
        # exit would never run. The elastic supervisor sees 101 and
        # relaunches; resume() continues from the emergency checkpoint.
        os._exit(ELASTIC_EXIT_CODE)

    # -- the loop ---------------------------------------------------------
    def run_step(self, batch) -> Optional[float]:
        """One guarded step. Returns the (finite) loss, or None when the
        step was skipped by the NaN/Inf sentinel."""
        from ..testing import chaos as _chaos

        fault = _chaos.fire("train.step")
        if fault is not None and fault.kind == "raise":
            raise _chaos.ChaosInjected("chaos: train step failure")
        if fault is not None and fault.kind == "exit":
            # simulated rank loss: the process vanishes mid-step with no
            # cleanup, no checkpoint, no exception — peers discover it
            # through the launcher's death watch / stale heartbeat lease
            os._exit(int(fault.args.get("code", 1)))
        with self.watchdog.guard(f"step{self.step}"):
            with _obs.span("train.step", step=self.step):
                if fault is not None and fault.kind == "hang":
                    time.sleep(float(fault.args.get("seconds", 1.0)))
                loss, new_state = self.step_fn(self.state, batch)
                # the blocking fetch the guard covers
                loss_val = float(loss)
        if fault is not None and fault.kind == "nan":
            loss_val = float("nan")
        if not math.isfinite(loss_val):
            # poisoned step: do NOT commit new_state — params/moments
            # computed from a non-finite loss are garbage
            self.bad_streak += 1
            self.stats["skipped"] += 1
            logger.warning("non-finite loss at step %d (streak %d/%d); "
                           "step skipped", self.step, self.bad_streak,
                           self.max_bad_steps)
            if self.donated_step or self.bad_streak >= self.max_bad_steps:
                # donated buffers: the old state died with the discarded
                # step — a checkpoint restore is the only usable state
                self._rollback()
            return None
        self.bad_streak = 0
        self.state = new_state
        self.step += 1
        if self.step % self.save_every == 0:
            self._save()
        return loss_val

    def run(self, batches, total_steps: int) -> Optional[float]:
        """Drive ``run_step`` until ``total_steps`` commits; ``batches``
        is a callable ``step -> batch`` or an iterable."""
        if callable(batches):
            get = batches
        else:
            it = iter(batches)
            get = lambda _step: next(it)  # noqa: E731
        last = None
        while self.step < total_steps:
            out = self.run_step(get(self.step))
            if out is not None:
                last = out
        return last
