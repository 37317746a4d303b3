"""Communication and step watchdogs (the port's copy of
paddle_tpu/distributed/comm_watchdog.py).

:class:`CommTaskManager` tracks in-flight communication tasks
(``register`` / ``complete``) and a daemon thread reports any task alive
past its timeout, with its name and age, instead of an opaque stall.
:class:`StepWatchdog` arms a timer around each step's blocking region: a
hang inside a step (a peer missing from a collective, a wedged device)
registers no task, it just blocks the caller, and the timer fires
``on_hang(tag, age_s)`` once per armed region.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

__all__ = ["CommTaskManager", "comm_task_manager", "start_comm_watchdog",
           "stop_comm_watchdog", "StepWatchdog", "watched_step"]

logger = logging.getLogger("paddle_tpu_torch.distributed.comm_watchdog")


class CommTaskManager:
    """Tracks in-flight communication tasks; a watch thread reports any
    task older than ``timeout`` seconds via logging and the optional
    ``on_hang(name, age_s)`` callback (once per task)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[int, tuple[str, float]] = {}
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._timeout = 30.0
        self._on_hang: Optional[Callable[[str, float], None]] = None
        self._flagged: set[int] = set()
        self.enabled = False

    # -- registration -------------------------------------------------------
    def register(self, name: str) -> Optional[int]:
        if not self.enabled:
            return None
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = (name, time.monotonic())
        return tid

    def complete(self, tid: Optional[int]) -> None:
        if tid is None:
            return
        with self._lock:
            self._tasks.pop(tid, None)
            self._flagged.discard(tid)

    # -- watch loop ---------------------------------------------------------
    def start(self, timeout: float = 30.0, poll: float = 1.0,
              on_hang: Optional[Callable[[str, float], None]] = None):
        self._timeout = timeout
        self._on_hang = on_hang
        self._stop.clear()
        self.enabled = True
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, args=(poll,), daemon=True,
                name="paddle-tpu-torch-comm-watchdog")
            self._thread.start()

    def stop(self):
        self.enabled = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            self._tasks.clear()
            self._flagged.clear()

    def _loop(self, poll: float):
        while not self._stop.wait(poll):
            now = time.monotonic()
            hung = []
            with self._lock:
                for tid, (name, t0) in self._tasks.items():
                    if now - t0 > self._timeout and tid not in self._flagged:
                        self._flagged.add(tid)
                        hung.append((name, now - t0))
            for name, age in hung:
                logger.error(
                    "comm watchdog: task '%s' in flight for %.1fs "
                    "(timeout %.1fs) — possible communication hang",
                    name, age, self._timeout)
                if self._on_hang is not None:
                    self._on_hang(name, age)

    # -- introspection ------------------------------------------------------
    def in_flight(self):
        with self._lock:
            now = time.monotonic()
            return [(name, now - t0) for name, t0 in self._tasks.values()]


comm_task_manager = CommTaskManager()


def start_comm_watchdog(timeout: float = 30.0, poll: float = 1.0,
                        on_hang=None):
    """Enable hang detection for registered communication tasks."""
    comm_task_manager.start(timeout=timeout, poll=poll, on_hang=on_hang)


def stop_comm_watchdog():
    comm_task_manager.stop()


class StepWatchdog:
    """Step hang watchdog: arms a timer around each step's blocking
    region; if the step does not complete in ``timeout`` seconds,
    ``on_hang(tag, age_s)`` fires (after a log line and a faulthandler
    dump of every thread's stack), once per armed region.

    Usage::

        wd = StepWatchdog(timeout=120)
        for batch in loader:
            with wd.guard("train_step"):
                loss, state = step(state, batch)
                loss_val = float(loss)       # the blocking fetch
    """

    def __init__(self, timeout: float = 120.0,
                 on_hang: Optional[Callable[[str, float], None]] = None):
        self.timeout = timeout
        self.on_hang = on_hang
        self.hang_count = 0

    def _fire(self, tag: str):
        self.hang_count += 1
        logger.error(
            "step %r has not completed within %.1fs — likely a hung "
            "collective (a peer missing from the program) or a wedged "
            "device; dumping stacks", tag, self.timeout)
        try:
            import faulthandler
            import sys

            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:  # noqa: BLE001 — diagnostics must not throw
            pass
        if self.on_hang is not None:
            self.on_hang(tag, self.timeout)

    def guard(self, tag: str = "step"):
        return _StepGuard(self, tag)


class _StepGuard:
    def __init__(self, wd: StepWatchdog, tag: str):
        self._wd = wd
        self._tag = tag
        self._timer: Optional[threading.Timer] = None

    def __enter__(self):
        self._timer = threading.Timer(self._wd.timeout, self._wd._fire,
                                      args=(self._tag,))
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    elif hasattr(tree, "device") and getattr(tree.device, "type",
                                              None) == "cuda":
        out.add(tree.device)
    return out


def watched_step(step_fn, timeout: float = 120.0,
                 on_hang: Optional[Callable[[str, float], None]] = None,
                 tag: str = "step"):
    """Wrap a step function with a StepWatchdog guard; the returned
    callable waits until the outputs are computed (a synchronize of
    every CUDA device its output tensors live on), so that a hang is
    caught here, not at a later unrelated read."""
    wd = StepWatchdog(timeout=timeout, on_hang=on_hang)

    def run(*args, **kwargs):
        with wd.guard(tag):
            out = step_fn(*args, **kwargs)
            for dev in _cuda_devices(out, set()):
                import torch

                torch.cuda.synchronize(dev)
            return out

    run.watchdog = wd
    return run
