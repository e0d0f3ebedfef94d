"""Metrics: confusion-matrix mIoU and running meters, counterpart of
``css_tpu/utils/metrics.py``.

The device side accumulates the [C, C] matrix (``train/train_step.py``
``make_eval_step``, a ``torch.bincount``); this module is the host-side
bookkeeping: the matrix container, the mIoU reduction and the wall-clock
``AverageMeter``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConfusionMatrix", "mean_iou", "per_class_iou", "AverageMeter"]


def per_class_iou(mat: np.ndarray) -> np.ndarray:
    """IoU per class = diag / (rowsum + colsum - diag); empty classes are NaN."""
    mat = np.asarray(mat, np.float64)
    diag = np.diag(mat)
    denom = mat.sum(1) + mat.sum(0) - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        return diag / denom


def mean_iou(mat: np.ndarray) -> float:
    """mIoU = mean over classes of the per-class IoU; a NaN class poisons the
    mean, as the reference's ``torch.mean`` over the vector does."""
    return float(np.mean(per_class_iou(mat)))


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, mat) -> None:
        self.mat += np.asarray(mat, np.int64)

    def reset(self) -> None:
        self.mat[:] = 0

    @property
    def miou(self) -> float:
        return mean_iou(self.mat)

    @property
    def iou(self) -> np.ndarray:
        return per_class_iou(self.mat)


class AverageMeter:
    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)
