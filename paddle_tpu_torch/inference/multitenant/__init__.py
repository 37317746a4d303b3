"""Multi-tenant serving over the unified engine (port of
paddle_tpu/inference/multitenant/).

Three request-diversity axes, each per-row data of the one step program
(inference/serving.py):

- ``lora``: per-request LoRA adapters, resident as refcounted,
  content-hashed pages of the KV page pool and applied across the packed
  batch by one grouped BGMV kernel (ops/kernels/lora_matmul.py);
- priority classes with preemption (the engine's scheduler): under pool
  pressure a lower-priority resident gives up its KV pages and resumes
  later through the prefix cache;
- ``constrain``: schema-constrained decoding, a per-row vocabulary mask
  applied to the logits before the sampler.

Each is behind a flag (``serving_lora``, ``serving_priorities``,
``serving_constrained``); off, the engine's streams are unchanged.
"""

from .constrain import ConstraintState, TokenDfa, json_schema_dfa
from .lora import AdapterStore, make_lora

__all__ = ["AdapterStore", "ConstraintState", "TokenDfa",
           "json_schema_dfa", "make_lora"]
