"""Inference: segment images with a port checkpoint, counterpart of
``css_tpu/cli/predict_main.py``.

    python -m css_tpu_torch.cli.entries predict \\
        --checkpoint checkpoints/VOC_92_baseline/best_model \\
        --inputs path/to/images_or_dir --out_dir preds/ [--sliding] [--overlay]

Each image is padded on the host to the config's canvas (downscaled with PIL
BILINEAR first when larger), segmented by the EMA teacher (``--student``: the
student) on the card unless ``--device cpu`` is given, over the whole canvas
in one pass or with ``--sliding`` overlapping crop-sized windows averaged by
coverage, un-padded and brought back to its own size with NEAREST.  Writes
``<name>_pred.png`` (class indices) and with ``--overlay``
``<name>_overlay.png`` (the image blended half and half with the class
colours).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from css_tpu_torch import resolve_device
from css_tpu_torch.cli.evaluate_main import load_eval_model
from css_tpu_torch.config import CONFIG_DIR, load_config
from css_tpu_torch.ops.augment import normalize_imagenet, to_channel_first, to_channel_last
from css_tpu_torch.train.train_step import eval_mode, window_probs

__all__ = ["predict_parser", "segment", "colors", "main"]

_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")

# Cityscapes trainId colours (the cityscapesScripts table)
_CITYSCAPES_COLORS = [
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156), (190, 153, 153),
    (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100),
    (0, 80, 100), (0, 0, 230), (119, 11, 32),
]


def _voc_palette(n: int):
    """The VOC colour map, derived bit by bit from the class index."""
    pal = []
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        pal.append((r, g, b))
    return pal


def colors(num_classes: int):
    return _CITYSCAPES_COLORS if num_classes == 19 else _voc_palette(num_classes)


def predict_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="css_tpu_torch.cli.entries predict",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str,
                   default=os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"))
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--inputs", type=str, nargs="+", required=True,
                   help="image files and/or directories")
    p.add_argument("--out_dir", type=str, default="./predictions")
    p.add_argument("--student", action="store_true")
    p.add_argument("--sliding", action="store_true",
                   help="overlapping-window inference over the full canvas")
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--overlay", action="store_true",
                   help="also write colour overlays (<name>_overlay.png)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def _gather_inputs(paths):
    out = []
    for p in paths:
        if os.path.isdir(p):
            out += sorted(os.path.join(p, f) for f in os.listdir(p)
                          if f.lower().endswith(_EXTENSIONS))
        else:
            out.append(p)
    return out


def segment(model, image: torch.Tensor, num_classes: int, crop_hw, sliding: bool,
            stride=None) -> torch.Tensor:
    """[B, H, W] int64 classes of ``model`` (put in eval mode here) on the
    normalized NHWC canvases ``image``: one pass over the whole canvas, or
    with ``sliding`` windows of ``crop_hw`` every ``stride`` (default 2/3 of
    the crop per axis), the softmax averaged by coverage."""
    if sliding:
        window = tuple(crop_hw)
        step = (stride or 2 * window[0] // 3, stride or 2 * window[1] // 3)
    else:
        window = step = (int(image.shape[1]), int(image.shape[2]))
    with torch.no_grad(), eval_mode(model):
        return torch.argmax(window_probs(model, image, window, step, num_classes), dim=-1)


def _load_canvas(path: str, canvas):
    """(the image padded to ``canvas`` [H, W, 3] uint8, (h, w) it fills,
    (h, w) of the file): larger images are first downscaled into the canvas
    with PIL BILINEAR."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    ow, oh = im.size
    ch, cw = canvas
    if oh > ch or ow > cw:
        scale = min(ch / oh, cw / ow)
        im = im.resize((int(ow * scale), int(oh * scale)), Image.BILINEAR)
    arr = np.asarray(im, np.uint8)
    h, w = arr.shape[:2]
    pad = np.zeros((ch, cw, 3), np.uint8)
    pad[:h, :w] = arr
    return pad, (h, w), (oh, ow)


def _write(path: str, out_dir: str, pred: np.ndarray, fill, orig, palette, overlay: bool):
    from PIL import Image

    name = os.path.splitext(os.path.basename(path))[0]
    (h, w), (oh, ow) = fill, orig
    lab = pred[:h, :w].astype(np.uint8)
    if (h, w) != (oh, ow):    # segmented a downscaled copy: back to the input's pixels
        lab = np.asarray(Image.fromarray(lab, "L").resize((ow, oh), Image.NEAREST))
    Image.fromarray(lab, "L").save(os.path.join(out_dir, f"{name}_pred.png"))
    if overlay:
        base = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        mix = (0.5 * base + 0.5 * palette[lab]).astype(np.uint8)
        Image.fromarray(mix).save(os.path.join(out_dir, f"{name}_overlay.png"))


def main(argv=None) -> None:
    args = predict_parser().parse_args(argv)
    if not os.path.exists(args.checkpoint):
        sys.exit(f"error: checkpoint not found: {args.checkpoint}")
    files = _gather_inputs(args.inputs)
    if not files:
        sys.exit("error: no input images found")
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    num_classes = cfg.require("Network.num_class")
    crop = tuple(cfg.require("Dataset.crop_size"))
    canvas = tuple(cfg.get("Dataset.canvas_size", crop))
    model, epoch, _ = load_eval_model(cfg, args.checkpoint, args.student, device)
    os.makedirs(args.out_dir, exist_ok=True)
    palette = np.asarray(colors(num_classes), np.uint8)
    which = "student" if args.student else "teacher"
    print(f"segmenting {len(files)} image(s) with {which} @ epoch {epoch} "
          f"({'sliding' if args.sliding else 'whole-canvas'})")
    for start in range(0, len(files), args.batch_size):
        chunk = files[start:start + args.batch_size]
        loaded = [_load_canvas(f, canvas) for f in chunk]
        batch = torch.from_numpy(np.stack([c for c, _, _ in loaded])).to(device)
        image = to_channel_last(normalize_imagenet(to_channel_first(batch.float() / 255.0)))
        preds = segment(model, image, num_classes, crop, args.sliding, args.stride).cpu().numpy()
        for f, pred, (_, fill, orig) in zip(chunk, preds, loaded):
            _write(f, args.out_dir, pred, fill, orig, palette, args.overlay)
    print(f"wrote predictions to {args.out_dir}")
