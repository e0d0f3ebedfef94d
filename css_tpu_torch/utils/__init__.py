"""Host-side utilities: metrics, logging, profiling and preemption."""

from css_tpu_torch.utils.logging import Logger, ScalarWriter
from css_tpu_torch.utils.metrics import AverageMeter, ConfusionMatrix, mean_iou, per_class_iou

__all__ = ["AverageMeter", "ConfusionMatrix", "Logger", "ScalarWriter", "mean_iou",
           "per_class_iou"]
