"""Elastic training: membership, health, relaunch (the port's copy of
paddle_tpu/distributed/fleet/elastic.py).

Membership rides the rendezvous store (``distributed/store.py``): each
node heartbeats ``elastic/beat/<host>`` with a timestamp and the manager
reads stale leases as departed nodes. On a membership change the trainer
checkpoints and exits with ``ELASTIC_EXIT_CODE``; :func:`run_elastic`
relaunches the generation (a fresh process each time, so a CUDA child
inherits no CUDA context and finds its kernels already built under
``paddle_tpu_torch/build/``) and the trainers resume from their newest
valid checkpoint.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ...testing import chaos as _chaos
from ..store import TCPStore

__all__ = ["ElasticManager", "ElasticController", "ELASTIC_EXIT_CODE",
           "run_elastic"]

ELASTIC_EXIT_CODE = 101          # reference manager.py:33
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102


class ElasticManager:
    def __init__(self, host: Optional[str] = None, store: Optional[TCPStore]
                 = None, np: int = 1, ttl: float = 60.0,
                 heartbeat_interval: float = 10.0,
                 on_change: Optional[Callable[[list], None]] = None,
                 master: str = "127.0.0.1:6170", is_master: bool = False):
        self.host = host or os.environ.get("POD_IP", f"pid-{os.getpid()}")
        self.np = int(os.environ.get("PADDLE_ELASTIC_NP", np))
        self.ttl = float(os.environ.get("PADDLE_ELASTIC_TTL", ttl))
        self.heartbeat_interval = heartbeat_interval
        self.on_change = on_change
        if store is None:
            h, _, p = master.partition(":")
            store = TCPStore(h, int(p or 6170), is_master=is_master,
                             world_size=self.np)
        self.store = store
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.hosts: list[str] = []
        self.elastic_level = int(os.environ.get(
            "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", 1))

    # -- membership ---------------------------------------------------------
    def register(self):
        """Join + start heartbeating (the etcd lease of the reference).

        Membership uses per-host keys claimed via the atomic counter — a
        read-modify-write of one list would drop concurrently registering
        hosts (the etcd node-dir this replaces is also per-key)."""
        if self.host not in self._read_hosts():
            idx = self.store.add("elastic/nhosts", 1) - 1
            self.store.set(f"elastic/hostname/{idx}", self.host)
        self._beat()
        t = threading.Thread(target=self._heartbeat_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _beat(self):
        fault = _chaos.fire("elastic.heartbeat")
        if fault is not None and fault.kind == "drop":
            return   # injected dropped beat: the lease goes stale
        self.store.set(f"elastic/beat/{self.host}", str(time.time()))
        self.store.add(f"elastic/beat_flag/{self.host}", 1)

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            self._beat()

    def _read_hosts(self) -> list:
        n = self.store.add("elastic/nhosts", 0)
        return [self.store.get(f"elastic/hostname/{i}").decode()
                for i in range(n)]

    def live_hosts(self) -> list:
        """Hosts whose heartbeat is within TTL (stale leases expire)."""
        now = time.time()
        live = []
        for h in self._read_hosts():
            if self.store.add(f"elastic/beat_flag/{h}", 0) < 1:
                continue
            ts = float(self.store.get(f"elastic/beat/{h}").decode())
            if now - ts <= self.ttl:
                live.append(h)
        return live

    # -- watch / rescale ----------------------------------------------------
    def _match(self, hosts: Optional[list] = None) -> bool:
        """reference manager.py:410 — live membership equals target np."""
        hosts = hosts if hosts is not None else self.live_hosts()
        return len(hosts) == self.np

    def watch(self, interval: float = 5.0):
        """Blocking watch loop: invokes on_change when membership changes
        (the trainer should checkpoint and exit ELASTIC_EXIT_CODE)."""
        prev = sorted(self.live_hosts())
        while not self._stop.wait(interval):
            cur = sorted(self.live_hosts())
            if cur != prev:
                prev = cur
                if self.on_change is not None:
                    self.on_change(cur)

    def endpoints(self, port: int = 8200) -> str:
        """Recomputed trainer endpoints, stable-sorted to minimize rank
        movement on scale-in (reference :513)."""
        return ",".join(f"{h}:{port}" for h in sorted(self.live_hosts()))

    def exit(self, completed: bool = True):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)


class ElasticController:
    """Trainer-side elastic glue (reference manager.py launch_watch +
    the trainer's pre-train hook): heartbeats membership, watches for a
    live-host set that no longer matches the launched world size, and
    tells the training loop to checkpoint and exit for rescale.

    Usage in a training loop::

        ctl = ElasticController(manager, world_size)
        ctl.start()
        for step in ...:
            if ctl.should_rescale():
                save_checkpoint(...)
                ctl.exit_for_rescale()      # sys.exit(101)
            train_step(...)
    """

    def __init__(self, manager: ElasticManager, world_size: int,
                 interval: float = 1.0):
        self.manager = manager
        self.world_size = world_size
        self.interval = interval
        self._rescale = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.manager.register()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self):
        assembled = False
        while not self.manager._stop.wait(self.interval):
            live = self.manager.live_hosts()
            if not assembled:
                # launch skew grace: peers register at different times,
                # and a rescaled-down generation can still see the dead
                # node's unexpired lease — require EXACT assembly before
                # a deviation means an actual membership change
                assembled = len(live) == self.world_size
                continue
            if live and len(live) != self.world_size:
                self._rescale.set()
                if self.manager.on_change is not None:
                    self.manager.on_change(live)
                return

    def should_rescale(self) -> bool:
        return self._rescale.is_set()

    def exit_for_rescale(self):
        import sys

        self.manager.exit(completed=False)
        sys.exit(ELASTIC_EXIT_CODE)


def run_elastic(script: str, script_args=None, nprocs: int = 1,
                max_restarts: int = 3, log_dir=None, master=None,
                env_extra=None, nprocs_fn: Optional[Callable[[int], int]]
                = None) -> int:
    """Elastic trainer supervision (reference manager.py:125 watch loop +
    controller relaunch): run the fleet via the launch controller; when a
    generation exits with ELASTIC_EXIT_CODE (membership change — the
    trainer checkpointed and asked for relaunch) or dies abnormally,
    relaunch with a fresh rendezvous, up to ``max_restarts`` times.
    Returns the final generation's exit code (0 = trained to completion).

    ``nprocs_fn(attempt)``: per-generation world size — the reference's
    endpoint recomputation on relaunch (manager.py:410-513). Pass a
    membership probe (e.g. ``lambda a: len(mgr.live_hosts())``) so a
    generation launched after a node loss runs at the NEW world size and
    the trainers reshard their checkpoint on load.
    """
    from ..launch import launch_procs

    attempt = 0
    while True:
        # attempt 0 is the INITIAL launch: membership probes are empty
        # before any trainer heartbeats, so only restarts recompute
        world = nprocs if (nprocs_fn is None or attempt == 0) else max(
            1, int(nprocs_fn(attempt)))
        env = dict(env_extra or {})
        env["PADDLE_ELASTIC_RESTART"] = str(attempt)
        env["PADDLE_ELASTIC_NP"] = str(world)
        # per-generation subdir: a relaunch must not truncate the previous
        # generation's logs (they hold the crash being debugged)
        gen_dir = None if log_dir is None else \
            os.path.join(log_dir, f"restart_{attempt}")
        rc = launch_procs(script, list(script_args or []), world,
                          master=master, env_extra=env, log_dir=gen_dir)
        if rc == 0:
            return 0
        if attempt >= max_restarts:
            return rc
        if rc not in (ELASTIC_EXIT_CODE, ELASTIC_AUTO_PARALLEL_EXIT_CODE):
            # abnormal death: fault-tolerance level 1 also relaunches
            # (reference PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL semantics)
            import logging

            logging.getLogger("paddle_tpu_torch.elastic").warning(
                "generation %d died rc=%d; relaunching (%d/%d)",
                attempt, rc, attempt + 1, max_restarts)
        attempt += 1
