"""Worker for the port's chaos end-to-end tests (tests/test_torch_resilient.py):
a ResilientTrainLoop-driven toy trainer on the CPU, supervised by the
port's run_elastic, with faults armed through ``PT_CHAOS_PLAN``.

Single rank: generation 0 tears its step-3 save and dies on an injected
step failure; the relaunched generation runs with the plan disarmed,
resumes from the newest checkpoint that verifies (step 2) and trains to
completion. With ``CHAOS_MULTIHOST=1``, two ranks run in lockstep (a
store barrier a step), a rank-targeted ``exit`` kills rank 1 mid-step,
the launcher reaps the survivor, and the healed generation agrees on the
fleet-wide newest valid step through ``resume_fleet``.

Prints the RESUMED / STEP / DONE markers the tests read.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.parallel.resilient_loop import ResilientTrainLoop
from paddle_tpu_torch.testing import chaos

gen = int(os.environ.get("PADDLE_ELASTIC_RESTART", "0"))
multihost = os.environ.get("CHAOS_MULTIHOST") == "1"
total_steps = int(os.environ.get("CHAOS_TOTAL_STEPS", "8"))
rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
ckpt = os.environ["CHAOS_CKPT_DIR"]
if multihost:
    # every process is its own "host": a checkpoint history of its own
    ckpt = os.path.join(ckpt, f"rank{rank}")

# the plan armed at import targets the FIRST generation only: the
# relaunch must heal, not crash again
if gen != 0:
    chaos.disarm()

rng = np.random.RandomState(0)
X = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
Y = torch.from_numpy((X.numpy() @ rng.randn(16, 4) * 0.1)
                     .astype(np.float32))
W0 = torch.from_numpy(rng.randn(16, 4).astype(np.float32) * 0.01)


def step_fn(state, batch):
    x, y = batch
    w = state["w"].detach().clone().requires_grad_(True)
    loss = ((x @ w - y) ** 2).mean()
    (g,) = torch.autograd.grad(loss, w)
    return loss.detach(), {"w": (w - 0.1 * g).detach()}


loop = ResilientTrainLoop(step_fn, {"w": W0.clone()}, ckpt, save_every=1,
                          keep_last_k=4 if multihost else 3,
                          max_bad_steps=2, step_timeout=60.0, retries=2)
store = None
if multihost:
    host, _, port = os.environ["PADDLE_MASTER"].partition(":")
    store = TCPStore(host, int(port), is_master=rank == 0, world_size=world)
    agreed = loop.resume_fleet(store, rank, world, tag=f"gen{gen}/resume")
    print(f"RESUMED agreed={-1 if agreed is None else agreed} "
          f"step={loop.step}", flush=True)
else:
    resumed = loop.resume()
    print(f"RESUMED step={-1 if resumed is None else resumed}", flush=True)

loss = None
while loop.step < total_steps:
    if store is not None:
        # lockstep: nobody enters step N+1 before every rank committed N
        store.barrier(f"gen{gen}/lockstep/{loop.step}", world,
                      timeout=120.0)
    loss = loop.run_step((X, Y))
    if loss is not None:
        print(f"STEP {loop.step} LOSS {loss:.6f}", flush=True)

print(f"DONE step={loop.step} final_loss={loss:.6f} "
      f"stats={loop.stats}", flush=True)
sys.exit(0)
