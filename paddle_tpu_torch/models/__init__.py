"""The model zoo (port of paddle_tpu/models/): GPT (``models.gpt``),
LLaMA (``models.llama``) and BERT (``models.bert``); the package
exports the reference's GPT names."""

from .gpt import (GPT, GPTConfig, gpt_presets, init_params,  # noqa: F401
                  loss_fn, model_apply)

__all__ = ["GPT", "GPTConfig", "gpt_presets", "init_params", "model_apply",
           "loss_fn"]
