"""TCPStore: the rendezvous key-value store (the port's copy of
paddle_tpu/distributed/store.py).

The surface is the reference's: ``set``, blocking ``get``, ``add``,
``wait`` and a counter barrier whose key can be reused. The reference
backs it with its own C++ server; the port backs it with
``torch.distributed.TCPStore``, PyTorch's own rendezvous store, present
wherever torch is. Its errors are mapped onto the ones the resilient
loop retries (``with_retries`` catches ConnectionError, TimeoutError and
OSError): a ``get`` that times out raises TimeoutError, a connection
that cannot be made raises ConnectionError. Without ``torch.distributed``
a one-process store falls back to an in-process dict
(:class:`_LocalStore`), as the reference does without its library.

Chaos points: ``store.connect`` / ``store.get`` / ``store.set`` /
``store.add`` (testing/chaos.py), no-ops unless a plan is armed.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Optional

from ..testing import chaos as _chaos

__all__ = ["TCPStore", "Store"]


class Store:
    def set(self, key: str, value) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, keys) -> None:
        for k in keys if isinstance(keys, (list, tuple)) else [keys]:
            self.get(k)


class _LocalStore(Store):
    """In-process store (one process, no ``torch.distributed``)."""

    def __init__(self, timeout: float = 900.0):
        self._kv: dict = {}
        self._cv = threading.Condition()
        self._timeout = timeout

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        with self._cv:
            self._kv[key] = bytes(value)
            self._cv.notify_all()

    def get(self, key):
        with self._cv:
            # a key a dead peer never sets must raise, not hang
            if not self._cv.wait_for(lambda: key in self._kv,
                                     timeout=self._timeout):
                raise TimeoutError(
                    f"store get({key!r}) timed out after {self._timeout}s")
            return self._kv[key]

    def add(self, key, amount):
        with self._cv:
            cur = int(self._kv.get(key, b"0"))
            cur += int(amount)
            self._kv[key] = str(cur).encode()
            self._cv.notify_all()
            return cur


def _torch_store_cls():
    """``torch.distributed.TCPStore``, or None where torch was built
    without distributed support."""
    import torch.distributed as dist

    return dist.TCPStore if dist.is_available() else None


def _mapped(exc: Exception) -> Exception:
    """torch's store errors as the exceptions the retry loop knows."""
    import torch.distributed as dist

    if isinstance(exc, dist.DistNetworkError):
        return ConnectionError(str(exc))
    if isinstance(exc, dist.DistStoreError):
        return TimeoutError(str(exc))
    return exc


class TCPStore(Store):
    def __init__(self, host: str = "127.0.0.1", port: int = 6170,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 900.0):
        self.host = host
        self.port = int(port)
        self.is_master = is_master
        self._timeout = datetime.timedelta(seconds=float(timeout))
        self._local: Optional[_LocalStore] = None
        self._server = None
        # one client per thread: a blocking get() on a shared connection
        # would hold it while the setter thread that must unblock it waits
        self._tls = threading.local()
        cls = _torch_store_cls()
        if cls is None:
            if world_size > 1:
                raise RuntimeError(
                    "TCPStore needs torch.distributed for multi-process "
                    "rendezvous")
            _chaos.raise_fault("store.connect")
            self._local = _LocalStore(timeout=timeout)
            return
        self._cls = cls
        if is_master:
            _chaos.raise_fault("store.connect")
            try:
                self._server = cls(host, self.port, None, True,
                                   timeout=self._timeout,
                                   wait_for_workers=False)
            except RuntimeError as e:
                raise _mapped(e) from e
            self._tls.client = self._server
        else:
            self._client()    # connect now: a bad address fails here

    def _client(self):
        c = getattr(self._tls, "client", None)
        if c is None:
            _chaos.raise_fault("store.connect")
            try:
                c = self._cls(self.host, self.port, None, False,
                              timeout=self._timeout)
            except RuntimeError as e:
                raise _mapped(e) from e
            self._tls.client = c
        return c

    # -- ops ----------------------------------------------------------------
    def set(self, key: str, value) -> None:
        _chaos.raise_fault("store.set")
        if self._local is not None:
            return self._local.set(key, value)
        if isinstance(value, str):
            value = value.encode()
        try:
            self._client().set(key, bytes(value))
        except RuntimeError as e:
            raise _mapped(e) from e

    def get(self, key: str) -> bytes:
        _chaos.raise_fault("store.get")
        if self._local is not None:
            return self._local.get(key)
        try:
            return bytes(self._client().get(key))
        except RuntimeError as e:
            raise _mapped(e) from e

    def add(self, key: str, amount: int = 1) -> int:
        _chaos.raise_fault("store.add")
        if self._local is not None:
            return self._local.add(key, amount)
        try:
            return int(self._client().add(key, int(amount)))
        except RuntimeError as e:
            raise _mapped(e) from e

    def barrier(self, key: str, world_size: int, timeout: float = 300.0):
        """Counter barrier: arrive, then wait for everyone.

        Polls with add(key, 0), a non-blocking peek (a blocking get would
        make the timeout unreachable when a peer dies before arriving).
        The counter is namespaced by a store-resident epoch so that the
        same key can be reused: the last arriver bumps the epoch, and a
        later use (the next elastic generation reusing the rendezvous
        key) starts from a fresh counter instead of passing at once on
        the previous use's count. A barrier that times out bumps the
        epoch too, abandoning its partial count."""
        epoch = self.add(f"{key}/epoch", 0)
        ckey = f"{key}/count/e{epoch}"
        arrived = self.add(ckey, 1)
        if arrived >= world_size:
            self.add(f"{key}/epoch", 1)   # exactly one caller sees this
            return
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.add(ckey, 0) >= world_size:
                return
            time.sleep(0.01)
        self.add(f"{key}/epoch", 1)       # abandon the partial count
        raise TimeoutError(f"barrier {key} timed out")
