"""Distributed checkpoint, format v2 (the port's copy of
paddle_tpu/distributed/checkpoint.py): the reference's files, byte for
byte in everything but the zip entries' timestamps, so that each package
reads what the other wrote.

Layout of a checkpoint directory: per process ``<rank>_0.npz`` (one
member ``<key>#<i>.npy`` a chunk), ``metadata_<rank>.json`` mapping each
flattened key to {global_shape, dtype, chunks: [{global_offset,
local_shape, file, array, crc32}]}, and ``manifest_<rank>.json`` (every
file the rank wrote with its size), written last, so that a save torn by
a kill is detectable. :func:`save_checkpoint` rotates ``<root>/step_%08d``
directories under an atomically replaced ``LATEST`` pointer, and
:func:`load_latest_valid` walks back from the newest step to the first
that passes :func:`verify_checkpoint`.

The port's tensors are whole, so it writes one chunk a tensor; loading
assembles each target from every chunk that overlaps it, so a checkpoint
the reference wrote from an array sharded over several devices loads
whole. Targets are written in place with ``copy_``, which casts to the
target's dtype and keeps its device.

bf16: numpy has no bfloat16 on a host without ml_dtypes. A bf16 tensor
is written as its 16-bit patterns under the npy descriptor ``'<V2'``,
which is what numpy writes for the reference's ml_dtypes bfloat16, and
the metadata names it ``"bfloat16"``; reading views the bytes back as
bf16. (The reference's own loader cannot read such a chunk: it assigns
the ``V2`` bytes into a bfloat16 buffer, which numpy refuses.)

Chaos point ``checkpoint.save`` (testing/chaos.py): ``torn``,
``torn_manifest``, ``missing_meta``, ``corrupt``, ``raise``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from ..testing import chaos as _chaos

__all__ = ["save_state_dict", "load_state_dict", "flatten_state_dict",
           "unflatten_state_dict", "save_checkpoint", "load_latest_valid",
           "verify_checkpoint", "latest_step", "step_dir",
           "CheckpointCorruption"]

logger = logging.getLogger("paddle_tpu_torch.distributed.checkpoint")

_SEP = "."
_FORMAT = 2                      # v2: crc32 chunks + manifest sentinel
_STEP_PREFIX = "step_"
_LATEST = "LATEST"
_BF16_DESCR = "<V2"              # numpy's descriptor of ml_dtypes bfloat16


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed integrity verification (crc mismatch, torn
    file, missing manifest/metadata)."""


def flatten_state_dict(state_dict, prefix=""):
    """Nested dict -> flat {dotted_key: leaf}."""
    flat = {}
    for k, v in state_dict.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_state_dict(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_state_dict(flat):
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's bytes, read in place (no copy)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8))


def _host_array(key: str, v, copy: bool) -> tuple[np.ndarray, str]:
    """(host array of the leaf's bytes, its dtype name). A tensor on the
    card is copied to the host here, so that the caller may go on
    writing it; a CPU tensor is cloned when ``copy`` (an async save)."""
    if isinstance(v, (tuple, list)):
        raise ValueError(
            f"{key}: a {type(v).__name__} leaf cannot be checkpointed (the "
            "format holds one array a key; the reference's writer fails on "
            "such a leaf too, inside np.asarray: 'inhomogeneous shape'). "
            "Store its parts under a dict.")
    if isinstance(v, torch.Tensor):
        t = v.detach()
        on_host = t.device.type == "cpu"
        t = t.contiguous() if on_host else t.cpu()
        if on_host and copy:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(v)
    if copy:
        a = a.copy()
    return a, str(a.dtype)


def _savez(f, arrays: dict, bf16: set) -> None:
    """``np.savez`` (stored zip, one ``.npy`` a member), with the names in
    ``bf16`` written under the bf16 descriptor over their raw bytes."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                if name in bf16:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.shape})
                    fid.write(np.ascontiguousarray(a).reshape(-1)
                              .view(np.uint8))
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


# -- async-save failure surfacing -------------------------------------------
#
# A background writer that swallowed its exception would turn "the
# checkpoint never happened" into a fact found at restore time. Failures
# re-raise from join() on the returned thread, and are kept so that the
# NEXT save re-raises them.

_async_errors: list[BaseException] = []
_async_errors_lock = threading.Lock()


class _AsyncSaveThread(threading.Thread):
    def __init__(self, target):
        super().__init__(daemon=True)
        self._target_fn = target
        self.exception: Optional[BaseException] = None
        self._raised = False

    def run(self):
        try:
            self._target_fn()
        except BaseException as e:  # noqa: BLE001 — surfaced, not swallowed
            self.exception = e
            with _async_errors_lock:
                _async_errors.append(e)
            logger.error("async checkpoint save failed: %r", e)

    def join(self, timeout=None):
        super().join(timeout)
        if self.exception is not None and not self._raised:
            self._raised = True
            with _async_errors_lock:
                if self.exception in _async_errors:
                    _async_errors.remove(self.exception)
            raise RuntimeError("async checkpoint save failed") \
                from self.exception


def _raise_pending_async_error():
    with _async_errors_lock:
        if not _async_errors:
            return
        err, _async_errors[:] = _async_errors[0], []
    raise RuntimeError("a previous async checkpoint save failed") from err


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save: bool = False):
    """Write this rank's data file, metadata and (last) manifest under
    directory ``path``. Every tensor is on the host, as a copy where the
    caller could change it, before this returns, also for an async save
    (the returned thread writes the files)."""
    _raise_pending_async_error()
    os.makedirs(path, exist_ok=True)
    rank = _rank()
    fname = f"{rank}_0.npz"
    meta = {"format": _FORMAT, "state_dict_metadata": {},
            "storage_metadata": {}}
    arrays_out: dict = {}
    bf16: set = set()
    for key, v in flatten_state_dict(state_dict).items():
        a, dtype = _host_array(key, v, copy=async_save)
        name = f"{key}#0"
        arrays_out[name] = a
        if dtype == "bfloat16":
            bf16.add(name)
        meta["state_dict_metadata"][key] = {
            "global_shape": list(a.shape),
            "dtype": dtype,
            "chunks": [{"global_offset": [0] * a.ndim,
                        "local_shape": list(a.shape),
                        "file": fname, "array": name, "crc32": _crc(a)}],
        }

    # probe in the calling thread: overlapping async saves would otherwise
    # race for the scheduled fault
    fault = _chaos.fire("checkpoint.save")

    def _write():
        if fault is not None and fault.kind == "raise":
            raise _chaos.ChaosInjected("chaos: checkpoint write failed")
        # tmp + atomic rename: a kill mid-save never leaves a torn npz
        # beside valid metadata; uniquified so that overlapping async
        # saves of one process do not interleave into one tmp file
        uid = f"{os.getpid()}.{threading.get_ident()}.{time.monotonic_ns()}"
        data_path = os.path.join(path, fname)
        tmp = os.path.join(path, f".{fname}.tmp.{uid}")
        with open(tmp, "wb") as f:
            _savez(f, arrays_out, bf16)
        os.replace(tmp, data_path)
        if fault is not None and fault.kind == "torn":
            # killed mid-npz-write: truncated data, no metadata/manifest
            with open(data_path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(data_path) // 2))
            return
        if fault is not None and fault.kind == "corrupt":
            nbytes = int(fault.args.get("nbytes", 4))
            with open(data_path, "r+b") as f:
                f.seek(max(0, os.path.getsize(data_path) // 2))
                chunk = f.read(nbytes)
                f.seek(-len(chunk), os.SEEK_CUR)
                f.write(bytes(b ^ 0xFF for b in chunk))
        # every process writes its own chunk metadata; load merges all
        if fault is None or fault.kind != "missing_meta":
            mtmp = os.path.join(path, f".metadata_{rank}.tmp.{uid}")
            with open(mtmp, "w") as f:
                json.dump(meta, f)
            os.replace(mtmp, os.path.join(path, f"metadata_{rank}.json"))
        if fault is not None and fault.kind == "torn_manifest":
            return   # killed between the metadata and the manifest
        # manifest LAST: its presence asserts every file above is complete
        listed = [fname, f"metadata_{rank}.json"]
        manifest = {
            "format": _FORMAT,
            "files": {fn: os.path.getsize(os.path.join(path, fn))
                      for fn in listed
                      if os.path.exists(os.path.join(path, fn))},
        }
        ntmp = os.path.join(path, f".manifest_{rank}.tmp.{uid}")
        with open(ntmp, "w") as f:
            json.dump(manifest, f)
        os.replace(ntmp, os.path.join(path, f"manifest_{rank}.json"))

    if async_save:
        t = _AsyncSaveThread(_write)
        t.start()
        return t
    _write()


def verify_checkpoint(path) -> tuple[bool, list[str]]:
    """Integrity check without loading into a model: manifest presence
    (v2), file existence and sizes, and each chunk's crc32. Returns
    ``(ok, problems)``; a v1 checkpoint (no crc or manifest anywhere)
    verifies with a logged warning."""
    problems: list[str] = []
    metas = sorted(glob.glob(os.path.join(path, "metadata_*.json")))
    if not metas:
        return False, [f"no metadata_*.json under {path}"]
    legacy = False
    for mpath in metas:
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"{os.path.basename(mpath)}: unreadable ({e})")
            continue
        rank = os.path.basename(mpath)[len("metadata_"):-len(".json")]
        v2 = meta.get("format", 1) >= 2
        if not v2:
            legacy = True
        man_path = os.path.join(path, f"manifest_{rank}.json")
        if v2:
            if not os.path.exists(man_path):
                problems.append(f"rank {rank}: manifest missing (torn save"
                                " — killed before the final sentinel write)")
            else:
                with open(man_path) as f:
                    manifest = json.load(f)
                for fn, size in manifest.get("files", {}).items():
                    full = os.path.join(path, fn)
                    if not os.path.exists(full):
                        problems.append(f"rank {rank}: file {fn} missing")
                    elif os.path.getsize(full) != size:
                        problems.append(
                            f"rank {rank}: file {fn} size "
                            f"{os.path.getsize(full)} != manifest {size}")
        npzs: dict = {}
        try:
            for key, info in meta["state_dict_metadata"].items():
                for ch in info["chunks"]:
                    if "crc32" not in ch:
                        continue
                    npz = npzs.get(ch["file"])
                    if npz is None:
                        npz = npzs[ch["file"]] = np.load(
                            os.path.join(path, ch["file"]))
                    if _crc(npz[ch["array"]]) != ch["crc32"]:
                        problems.append(f"{key}: chunk {ch['array']} crc "
                                        "mismatch (corrupt bytes)")
        except Exception as e:  # torn zip / missing member
            problems.append(f"rank {rank}: data file unreadable ({e})")
        finally:
            for npz in npzs.values():
                npz.close()
    if legacy and not problems:
        logger.warning("checkpoint %s is format v1 (no crc/manifest); "
                       "loading without integrity verification", path)
    return not problems, problems


def _as_bf16(buf: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(buf).view(torch.bfloat16)


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, offload: bool = False):
    """Fill ``state_dict``'s tensors in place from a checkpoint directory:
    each target is assembled on the host from every saved chunk that
    overlaps it (a crc32-carrying chunk is verified as it is read), then
    copied into the target, cast to its dtype, on its device."""
    meta = {"state_dict_metadata": {}}
    legacy = False
    for mpath in sorted(glob.glob(os.path.join(path, "metadata_*.json"))):
        with open(mpath) as f:
            part = json.load(f)
        if part.get("format", 1) < 2:
            legacy = True
        for key, info in part["state_dict_metadata"].items():
            cur = meta["state_dict_metadata"].get(key)
            if cur is None:
                meta["state_dict_metadata"][key] = info
            else:
                cur["chunks"].extend(info["chunks"])
    if not meta["state_dict_metadata"]:
        raise FileNotFoundError(f"no metadata_*.json under {path}")
    if legacy:
        logger.warning("checkpoint %s predates crc/manifest (format v1); "
                       "loading without integrity verification", path)
    files: dict = {}

    def _file(fname):
        if fname not in files:
            files[fname] = np.load(os.path.join(path, fname))
        return files[fname]

    missing = []
    try:
        for key, target in flatten_state_dict(state_dict).items():
            info = meta["state_dict_metadata"].get(key)
            if info is None:
                missing.append(key)
                continue
            if not isinstance(target, torch.Tensor):
                raise TypeError(
                    f"state_dict value for {key!r} must be a tensor")
            bf16 = info["dtype"] == "bfloat16"
            buf = np.zeros(tuple(info["global_shape"]),
                           dtype=np.int16 if bf16 else info["dtype"])
            for ch in info["chunks"]:
                data = _file(ch["file"])[ch["array"]]
                if "crc32" in ch and _crc(data) != ch["crc32"]:
                    raise CheckpointCorruption(
                        f"{key}: chunk {ch['array']} in {ch['file']} fails "
                        f"crc32 verification (corrupt checkpoint bytes)")
                if bf16:
                    data = data.view(np.int16)
                sl = tuple(slice(o, o + s) for o, s in
                           zip(ch["global_offset"], ch["local_shape"]))
                buf[sl] = data
            if tuple(target.shape) != buf.shape:
                raise ValueError(f"{key}: checkpoint shape {buf.shape} != "
                                 f"target shape {tuple(target.shape)}")
            src = _as_bf16(buf) if bf16 else torch.from_numpy(buf)
            with torch.no_grad():
                target.copy_(src)
    finally:
        # an NpzFile holds an open fd: a run resuming many times must not
        # leak one per load
        for f in files.values():
            f.close()
    if missing:
        raise KeyError(f"checkpoint at {path} is missing keys: {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")


# -- rotation + auto-resume -------------------------------------------------

def _step_dirs(root) -> list[tuple[int, str]]:
    out = []
    if not root:        # unset root (None/"") = no checkpoints
        return out
    for name in os.listdir(root) if os.path.isdir(root) else []:
        if name.startswith(_STEP_PREFIX):
            try:
                out.append((int(name[len(_STEP_PREFIX):]),
                            os.path.join(root, name)))
            except ValueError:
                continue
    return sorted(out)


def step_dir(root, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{step:08d}")


def latest_step(root) -> Optional[int]:
    """The step the ``LATEST`` pointer names, or None (an unset root
    reads as "no checkpoints", as an empty directory does)."""
    if not root:
        return None
    try:
        with open(os.path.join(root, _LATEST)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def save_checkpoint(state_dict, root, step: int, keep_last_k:
                    Optional[int] = None, coordinator_rank: int = 0):
    """Rotated save: write ``<root>/step_<step>``, atomically replace the
    ``LATEST`` pointer, prune to the newest ``keep_last_k`` step
    directories (None/0 keeps everything). The pointer and the pruning
    are the coordinator's."""
    os.makedirs(root, exist_ok=True)
    save_state_dict(state_dict, step_dir(root, step))
    if _rank() != coordinator_rank:
        return
    tmp = os.path.join(root, f".{_LATEST}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(str(int(step)))
    os.replace(tmp, os.path.join(root, _LATEST))
    if keep_last_k and keep_last_k > 0:
        dirs = _step_dirs(root)
        for _, d in dirs[:-keep_last_k]:
            shutil.rmtree(d, ignore_errors=True)


def load_latest_valid(state_dict, root) -> Optional[int]:
    """Auto-resume: walk step directories newest first, load the first
    that passes integrity verification and return its step; None when
    no valid checkpoint exists. A torn or corrupt newest checkpoint is
    skipped with a warning."""
    for step, d in reversed(_step_dirs(root)):
        ok, problems = verify_checkpoint(d)
        if not ok:
            logger.warning("skipping invalid checkpoint %s: %s", d,
                           "; ".join(problems))
            continue
        try:
            load_state_dict(state_dict, d)
        except Exception as e:  # noqa: BLE001 — any load failure walks back
            logger.warning("checkpoint %s verified but failed to load "
                           "(%r); walking back", d, e)
            continue
        return step
    return None
