"""Checkpoint-format weight loading for the model zoo (port of
paddle_tpu/hapi/weights.py).

Reference behavior: ``pretrained=True`` downloads a ``.pdparams`` file
and ``set_state_dict``s it (python/paddle/vision/models/resnet.py:488 +
hapi/model.py load). This build is zero-egress, so the deliverable is
the LOADING/CONVERSION path: ``load_weights(model, path)`` reads a
local reference-format checkpoint (``.pdparams`` pickle of
name->ndarray, ``.npz``, or a torch-style ``.pt`` pickle of tensors),
normalizes naming-convention differences, shape-checks, and fills the
model's parameters. Model factories accept ``pretrained=<path>``.

Name normalization handles the conventions that differ across source
frameworks:
- ``module.`` DataParallel prefixes are stripped;
- torch BatchNorm ``running_mean/running_var`` -> ``_mean/_variance``;
- torch Linear kernels are [out, in] and are transposed to the
  reference's [in, out] layout when that (and only that) makes the
  shape match.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

__all__ = ["load_weights"]


def _read_checkpoint(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    with open(path, "rb") as f:
        obj = pickle.load(f)
    # common wrappers: {'state_dict': ...} (torch lightning style) or the
    # jit.save envelope used by this framework
    for key in ("state_dict", "model", "params"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key],
                                                               dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint structure in {path!r}")
    out = {}
    for k, v in obj.items():
        arr = np.asarray(v)
        if arr.dtype == object:
            raise ValueError(f"non-array entry {k!r} in checkpoint")
        out[k] = arr
    return out


def _normalize_name(name: str) -> str:
    if name.startswith("module."):
        name = name[len("module."):]
    name = name.replace(".running_mean", "._mean")
    name = name.replace(".running_var", "._variance")
    return name


def load_weights(model, path: str, name_map: Optional[dict] = None,
                 strict: bool = True) -> dict:
    """Fill ``model``'s state from a local checkpoint file.

    ``name_map``: optional {checkpoint_name: model_name} overrides applied
    after the built-in normalizations (the per-family mapping table).
    ``strict``: raise if any model parameter has no source value.
    Returns {"loaded": [...], "missing": [...], "unexpected": [...],
    "transposed": [...]}.
    """
    src = {_normalize_name(k): v for k, v in _read_checkpoint(path).items()}
    if name_map:
        for ck, mk in name_map.items():
            if ck in src:
                src[mk] = src.pop(ck)

    target = model.state_dict()
    report = {"loaded": [], "missing": [], "unexpected": [],
              "transposed": []}
    # torch checkpoints carry num_batches_tracked for BN; harmless extras
    ignorable = ("num_batches_tracked",)
    for name, param in target.items():
        arr = src.pop(name, None)
        if arr is None:
            report["missing"].append(name)
            continue
        want = tuple(param.shape)
        if tuple(arr.shape) != want:
            if arr.ndim == 2 and tuple(arr.T.shape) == want:
                arr = arr.T          # torch Linear [out,in] -> [in,out]
                report["transposed"].append(name)
            else:
                raise ValueError(
                    f"shape mismatch for {name!r}: checkpoint "
                    f"{tuple(arr.shape)} vs model {want}")
        param.set_value(arr.astype(np.asarray(param.numpy()).dtype))
        report["loaded"].append(name)
    report["unexpected"] = [k for k in src
                            if not k.endswith(ignorable)]
    if strict and report["missing"]:
        raise ValueError(f"checkpoint {path!r} is missing values for "
                         f"{report['missing'][:5]}"
                         f"{'...' if len(report['missing']) > 5 else ''}")
    return report


def maybe_load_pretrained(model, pretrained, arch: str = ""):
    """Factory-side hook: ``pretrained`` may be False (no-op), a local
    checkpoint path (loaded via :func:`load_weights`), or True — which
    raises with instructions, since this build has no network egress."""
    if not pretrained:
        return model
    if isinstance(pretrained, str):
        load_weights(model, pretrained)
        return model
    raise NotImplementedError(
        f"pretrained weights for {arch or type(model).__name__} are not "
        "bundled (zero-egress build); pass pretrained='/path/to/file"
        ".pdparams' (or .npz / torch-style pickle) to load local weights "
        "via paddle_tpu_torch.hapi.weights.load_weights")
