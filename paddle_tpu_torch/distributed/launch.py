"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch
train.py`` (the port's copy of paddle_tpu/distributed/launch.py).

:func:`launch_procs` starts one process a rank with the rendezvous
environment, prefixes or logs each rank's output, watches for deaths and
stops the whole fleet on the first failure. A process joins its group
with :func:`init_from_env`: ``torch.distributed.init_process_group``
(gloo for CPU tensors, nccl on the card) from the same environment.

Environment honoured:
  PADDLE_MASTER / MASTER_ADDR[:MASTER_PORT] -> the group's address
  PADDLE_TRAINERS_NUM / NNODES              -> world size
  PADDLE_TRAINER_ID / NODE_RANK             -> rank
"""

from __future__ import annotations

import os
import runpy
import socket
import subprocess
import sys
import threading
import time

__all__ = ["main", "init_from_env", "launch_procs"]


def init_from_env(device=None, backend: str | None = None) -> bool:
    """Join the process group the launcher's environment describes
    (``tcp://`` rendezvous at the master's address). ``backend`` None:
    gloo when ``device`` is the CPU, nccl on the card (the default) when
    every rank has a card of its own, gloo when the ranks outnumber the
    cards. ``backend="gloo"`` on the card lets several ranks share one
    device, which NCCL refuses (a communicator needs one device a rank):
    each rank's tensors stay on the card, the collectives run through
    gloo and its point-to-point sends through host copies
    (``autograd_collectives.ppermute``). Returns True if a multi-process
    group was found and joined."""
    master = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    nnodes = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                os.environ.get("NNODES", "1")))
    rank = int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("NODE_RANK", "0")))
    if nnodes <= 1 or not master:
        return False
    if ":" not in master:
        port = os.environ.get("MASTER_PORT", "8090")
        master = f"{master}:{port}"
    import torch.distributed as dist

    from ..core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        shared = nnodes > torch.cuda.device_count()
        backend = backend or ("gloo" if shared else "nccl")
        local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
        # ranks beyond the cards share them (gloo only)
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{master}",
                            world_size=nnodes, rank=rank)
    return True


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pump(stream, sink, prefix: str):
    for line in iter(stream.readline, b""):
        sink.write(f"{prefix}{line.decode(errors='replace')}")
        sink.flush()
    stream.close()


def launch_procs(script: str, script_args, nprocs: int,
                 master: str | None = None, env_extra=None,
                 log_dir: str | None = None,
                 timeout: float | None = None,
                 nnodes: int = 1, node_rank: int = 0) -> int:
    """Spawn/watch ``nprocs`` local trainer processes (the reference
    collective controller, launch/controllers/collective.py:75-236 +
    controller.py watch loop): wires the rendezvous env per rank, prefixes
    each rank's output, and on any failure terminates the remaining ranks
    (reference Controller.watch 'peer failure' semantics). Multi-node:
    with ``nnodes``/``node_rank`` set, ranks are globally numbered
    ``node_rank * nprocs + local`` out of ``nnodes * nprocs`` (all nodes
    must share ``master``). ``timeout=None`` waits indefinitely. Returns
    the first non-zero exit code, 0 if all succeeded."""
    if nnodes > 1 and not master:
        raise ValueError("multi-node launch requires an explicit --master")
    master = master or f"127.0.0.1:{_free_port()}"
    world = nnodes * nprocs
    procs, pumps, logs = [], [], []
    rc = 0
    try:
        for local in range(nprocs):
            rank = node_rank * nprocs + local
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update({
                "PADDLE_MASTER": master,
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_LOCAL_RANK": str(local),
                "PADDLE_RANK_IN_NODE": str(local),
            })
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                f = open(os.path.join(log_dir, f"worker.{rank}.log"), "wb")
                logs.append(f)
                p = subprocess.Popen([sys.executable, script, *script_args],
                                     env=env, stdout=f,
                                     stderr=subprocess.STDOUT)
            else:
                p = subprocess.Popen([sys.executable, script, *script_args],
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
                t = threading.Thread(target=_pump,
                                     args=(p.stdout, sys.stdout,
                                           f"[rank {rank}] "), daemon=True)
                t.start()
                pumps.append(t)
            procs.append(p)

        deadline = (time.monotonic() + timeout) if timeout else None
        while procs:
            alive = []
            for p in procs:
                code = p.poll()
                if code is None:
                    alive.append(p)
                elif code != 0 and rc == 0:
                    rc = code  # first failure: stop the fleet
            procs = alive
            timed_out = deadline is not None and time.monotonic() > deadline
            if rc != 0 or timed_out:
                if procs and rc == 0:
                    rc = 124  # timeout
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for t in pumps:
            t.join(timeout=5)
        for f in logs:
            f.close()
    return rc


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    args = list(argv)
    if not args:
        print("usage: python -m paddle_tpu_torch.distributed.launch "
              "[--nprocs N] [--nnodes N] [--master HOST:PORT] [--rank R] "
              "[--log_dir DIR] script.py [script args...]", file=sys.stderr)
        return 2
    nprocs, log_dir, timeout = 0, None, None
    nnodes, node_rank = 1, 0
    # minimal flag parsing: flags before the script path
    while args and args[0].startswith("--"):
        flag = args.pop(0).lstrip("-")
        if "=" in flag:
            flag, value = flag.split("=", 1)
        elif args:
            value = args.pop(0)
        else:
            print(f"missing value for --{flag}", file=sys.stderr)
            return 2
        if flag == "nprocs":
            nprocs = int(value)
        elif flag == "log_dir":
            log_dir = value
        elif flag == "timeout":
            timeout = float(value)
        elif flag == "nnodes":
            nnodes = int(value)
            os.environ["PADDLE_TRAINERS_NUM"] = value
        elif flag == "rank":
            node_rank = int(value)
            os.environ["PADDLE_TRAINER_ID"] = value
        elif flag == "master":
            os.environ["PADDLE_MASTER"] = value
    if not args:
        print("missing script path", file=sys.stderr)
        return 2
    script, script_args = args[0], args[1:]
    if nprocs > 1:
        return launch_procs(script, script_args, nprocs,
                            master=os.environ.get("PADDLE_MASTER"),
                            log_dir=log_dir, timeout=timeout,
                            nnodes=nnodes, node_rank=node_rank)
    init_from_env()
    sys.argv = [script] + script_args
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
