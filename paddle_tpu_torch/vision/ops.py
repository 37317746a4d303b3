"""Detection operators (port of paddle_tpu/vision/ops.py, first part):
the IoU matrix and the greedy NMS keep mask that ``multiclass_nms3``
(ops/parity.py) runs on. The rest of the reference module (roi_align,
deform_conv2d, yolo_box, nms, ...) is not ported yet.
"""

from __future__ import annotations

import torch

__all__: list = []


def _iou_matrix(boxes):
    """[..., N, 4] xyxy -> [..., N, N] IoU."""
    area = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * \
        torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _nms_keep_mask(boxes, scores, iou_threshold):
    """Greedy NMS in score order, a fixed-length loop on the device:
    box i is kept unless a kept box ranked above it overlaps it by more
    than ``iou_threshold``. ``scores`` [N], or [C, N] for C classes over
    the same boxes at once; returns the keep mask in box order."""
    batched = scores.ndim == 2
    s = scores if batched else scores[None]
    order = torch.argsort(-s, dim=-1, stable=True)          # [C, N]
    ordered = boxes[order]                                  # [C, N, 4]
    over = _iou_matrix(ordered) > iou_threshold             # [C, N, N]
    n = boxes.shape[0]
    keep = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    for i in range(1, n):
        keep[:, i] = ~(keep[:, :i] & over[:, i, :i]).any(-1)
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out if batched else out[0]
