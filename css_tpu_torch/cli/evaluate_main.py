"""Standalone checkpoint evaluation, counterpart of
``css_tpu/cli/evaluate_main.py``: the confusion-matrix mIoU of a port
checkpoint (``train/checkpoint.py``) on the validation split, the EMA teacher
by default or the student with ``--student``, printed per class and as the
mIoU line.

    python -m css_tpu_torch.cli.entries evaluate \\
        --checkpoint checkpoints/VOC_92_baseline/best_model --num_labels 92 \\
        [--synthetic] [--sliding [--stride S]] [--flip] [--scales 0.75,1.0,1.25]

Without ``--sliding`` each validation image is cropped once, as the
training driver's eval does, with the crop draws of the driver's eval number
``EVAL_INDEX`` (its first, after epoch 0); ``--sliding`` evaluates the whole
canvas with overlapping crop-sized windows.  ``--flip`` and ``--scales`` add
test-time augmentation to either.  It runs on one device, the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from css_tpu_torch import resolve_device
from css_tpu_torch.cli.train_main import _evaluate, _make_loaders
from css_tpu_torch.config import CONFIG_DIR, load_config
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train.checkpoint import restore_checkpoint
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import make_eval_step, make_sliding_eval_step

__all__ = ["EVAL_INDEX", "evaluate_parser", "evaluate", "load_eval_model", "class_names",
           "main"]

EVAL_INDEX = 0    # the driver's eval number whose crop draws the plain eval takes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def evaluate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="css_tpu_torch.cli.entries evaluate",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str,
                   default=os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"))
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_labels", type=int, default=92)
    p.add_argument("--student", action="store_true",
                   help="evaluate the student instead of the EMA teacher")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--txt_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--sliding", action="store_true",
                   help="sliding-window eval over the full canvas (overlapping crop-size "
                        "windows, averaged probabilities) instead of one random crop")
    p.add_argument("--stride", type=int, default=None,
                   help="sliding-window stride (default 2/3 of the crop)")
    p.add_argument("--flip", action="store_true",
                   help="test-time augmentation: average softmax probabilities with the "
                        "horizontally flipped input")
    p.add_argument("--scales", type=str, default="1.0",
                   help="test-time augmentation: comma-separated input rescales to average "
                        "over (e.g. 0.75,1.0,1.25); composes with --sliding and --flip")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def load_eval_model(cfg, checkpoint: str, student: bool, device: torch.device):
    """The network of ``cfg`` on ``device`` with the teacher's (or the
    student's) weights from the port checkpoint ``checkpoint``; returns
    (model, epoch, recorded mIoU)."""
    num_classes = cfg.require("Network.num_class")
    output_dim = cfg.get("Network.output_dim", 256)
    model = build_model(num_classes, output_dim, cfg.get("Network.backbone", "resnet101"),
                        dtype=_DTYPES[cfg.get("Network.dtype", "bfloat16")])
    state = create_train_state(model, num_classes, output_dim, base_lr=1e-3, weight_decay=0.0,
                               total_steps=1, device=device)
    state, epoch, best = restore_checkpoint(checkpoint, state)
    return (state.model if student else state.teacher), epoch, best


def _scales(parser, text: str):
    try:
        scales = tuple(float(s) for s in text.split(",") if s.strip())
    except ValueError:
        scales = ()
    if not scales or any(s <= 0 for s in scales):
        parser.error(f"--scales must be positive floats, got {text!r}")
    return scales


def evaluate(args, scales=(1.0,)):
    """The evaluation ``args`` describe; returns (ConfusionMatrix, epoch,
    recorded mIoU)."""
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    for flag, key in ((args.data_dir, "Dataset.data_dir"), (args.txt_dir, "Dataset.txt_dir")):
        if flag:
            cfg.set(key, flag)
    if args.synthetic:
        cfg.set("Dataset.name", "Synthetic")
    num_classes = cfg.require("Network.num_class")
    crop = tuple(cfg.require("Dataset.crop_size"))
    model, epoch, best = load_eval_model(cfg, args.checkpoint, args.student, device)
    if args.sliding:
        canvas = tuple(cfg.get("Dataset.canvas_size", crop))
        stride = (args.stride, args.stride) if args.stride else None
        step = make_sliding_eval_step(model, num_classes, canvas, crop, stride,
                                      flip=args.flip, scales=scales)
    else:
        step = make_eval_step(model, num_classes, flip=args.flip, scales=scales)
    loaders = _make_loaders(cfg, args, cfg.require("Dataset.batch_size"))
    try:
        cm = _evaluate(step, loaders[2], crop, num_classes, cfg.get("Seed", 3407), EVAL_INDEX,
                       device, full_canvas=args.sliding)
    finally:
        for loader in loaders:
            loader.close()
    return cm, epoch, best


def class_names(num_classes: int):
    """VOC's or Cityscapes' class names by the class count, else class_i."""
    voc = ["background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
           "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
           "pottedplant", "sheep", "sofa", "train", "tvmonitor"]
    cityscapes = ["road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
                  "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
                  "truck", "bus", "train", "motorcycle", "bicycle"]
    for names in (voc, cityscapes):
        if len(names) == num_classes:
            return names
    return [f"class_{i}" for i in range(num_classes)]


def main(argv=None):
    """Prints the per-class IoU and the mIoU line; returns the ConfusionMatrix."""
    parser = evaluate_parser()
    args = parser.parse_args(argv)
    scales = _scales(parser, args.scales)
    if not os.path.exists(args.checkpoint):
        sys.exit(f"error: checkpoint not found: {args.checkpoint}")
    cm, epoch, best = evaluate(args, scales)
    which = "student" if args.student else "teacher"
    for i, (name, iou) in enumerate(zip(class_names(cm.num_classes), cm.iou)):
        print(f"  class {i:2d} {name:<15s} IoU {'nan' if np.isnan(iou) else f'{iou:.4f}'}")
    print(f"checkpoint epoch {epoch} ({which}): mIoU {cm.miou:.4f} (best recorded {best:.4f})")
    return cm
