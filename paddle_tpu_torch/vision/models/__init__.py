"""Vision model zoo (port of paddle_tpu/vision/models/): the ResNet
family. The reference's other model files are ROADMAP Queue 1 item 7."""

from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext101_32x4d", "wide_resnet50_2",
    "wide_resnet101_2",
]
