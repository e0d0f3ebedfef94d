"""Dataset record specs: path layout and decode-to-canvas, counterpart of
``css_tpu/data/datasets.py``.

The host side decodes an image/label pair and pastes it into a fixed-size
canvas (image uint8 padded 0, label int32 padded 255 = ignore) with the
true (h, w) recorded; every stochastic transform runs on the device
(``ops/augment.py``).

Path layouts follow the reference:
  * VOC:        <root>/JPEGImages/<id>.jpg, <root>/SegmentationClassAug/<id>.png
  * Cityscapes: <root>/leftImg8bit/<mode>/<city>/<id>.png and
                <root>/gtFine/<mode>/<city>/<id minus "_leftImg8bit">_gtFine_trainIds.png

Decoding uses PIL, imported where a file is decoded, so the synthetic path
needs numpy alone.  ``SyntheticSpec`` makes deterministic pseudo-data with
the same record interface, the same bytes as ``css_tpu``'s for the same id.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["VOCSpec", "CityscapesSpec", "SyntheticSpec", "build_dataset_specs"]

# decoded-raw cache file header: [magic, h, w, reserved] int32
_CACHE_MAGIC = 0x43535243  # "CSRC"


@dataclasses.dataclass
class _CanvasSpec:
    canvas_hw: Tuple[int, int]
    # Opt-in decoded-raw cache: after the first decode a sample is stored as
    # a header + raw pixel bytes under this directory, and later epochs read
    # it back instead of decoding.  Best effort: a failed read decodes (and
    # rewrites the entry).
    cache_dir: Optional[str] = None

    def load(self, sample_id: str):
        """Returns (image_canvas uint8 [H, W, 3], label_canvas int32 [H, W],
        valid_hw (h, w))."""
        ch, cw = self.canvas_hw
        icanvas = np.zeros((ch, cw, 3), np.uint8)
        lcanvas = np.full((ch, cw), 255, np.int32)
        vhw = self.load_into(sample_id, icanvas, lcanvas)
        return icanvas, lcanvas, vhw

    def load_into(self, sample_id: str, icanvas: np.ndarray,
                  lcanvas: np.ndarray) -> np.ndarray:
        """Decodes straight into caller-provided canvases (rows of the batch
        arrays); ``icanvas`` must be pre-filled 0 and ``lcanvas`` 255.
        Returns valid_hw [2] int32."""
        if self.cache_dir:
            hw = self._load_cached_into(sample_id, icanvas, lcanvas)
            if hw is not None:
                return hw
        hw = self._decode_into(sample_id, icanvas, lcanvas)
        if self.cache_dir:
            self._store_cache(sample_id, icanvas, lcanvas, hw)
        return hw

    def _decode_into(self, sample_id: str, icanvas: np.ndarray,
                     lcanvas: np.ndarray) -> np.ndarray:
        img, lab = self._decode(sample_id)
        if lab is not None and lab.ndim == 3:
            # RGB label maps: trainIds replicated per channel, keep the first
            lab = lab[..., 0]
        ch, cw = self.canvas_hw
        h, w = img.shape[:2]
        if h > ch or w > cw:
            raise ValueError(f"sample {sample_id} ({h}x{w}) exceeds canvas {self.canvas_hw}")
        icanvas[:h, :w] = img
        if lab is not None:
            lcanvas[:h, :w] = lab
        return np.asarray([h, w], np.int32)

    # ---- decoded-raw cache ------------------------------------------------

    def _cache_key(self, sample_id: str) -> str:
        return sample_id

    def _cache_path(self, sample_id: str) -> str:
        return os.path.join(self.cache_dir, f"{self._cache_key(sample_id)}.rawc")

    def _load_cached_into(self, sample_id: str, icanvas, lcanvas):
        """Reads a cached sample into the canvases; None on a miss or a
        mismatch (the caller decodes and rewrites)."""
        ch, cw = self.canvas_hw
        try:
            with open(self._cache_path(sample_id), "rb") as f:
                head = np.frombuffer(f.read(16), np.int32)
                if head.size != 4 or int(head[0]) != _CACHE_MAGIC:
                    return None
                h, w = int(head[1]), int(head[2])
                if not (0 < h <= ch and 0 < w <= cw):
                    return None
                img = f.read(h * w * 3)
                lab = f.read(h * w)
                if len(img) != h * w * 3 or len(lab) != h * w:
                    return None
            icanvas[:h, :w] = np.frombuffer(img, np.uint8).reshape(h, w, 3)
            lcanvas[:h, :w] = np.frombuffer(lab, np.uint8).reshape(h, w)
            return np.asarray([h, w], np.int32)
        except OSError:
            return None

    def _store_cache(self, sample_id: str, icanvas, lcanvas, hw) -> None:
        h, w = int(hw[0]), int(hw[1])
        path = self._cache_path(sample_id)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # a temporary file per writer, then an atomic replace: two decode
            # workers caching one sample never interleave bytes
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                np.asarray([_CACHE_MAGIC, h, w, 0], np.int32).tofile(f)
                f.write(np.ascontiguousarray(icanvas[:h, :w]).tobytes())
                # labels are 0..num_class-1 or 255 = ignore: uint8 round-trips
                f.write(lcanvas[:h, :w].astype(np.uint8).tobytes())
            os.replace(tmp, path)
        except OSError:
            pass  # best effort: the next epoch decodes again

    def _decode(self, sample_id: str):
        raise NotImplementedError


def _read_pair(img_path: str, lab_path: str):
    from PIL import Image

    with Image.open(img_path) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    lab = None
    if os.path.exists(lab_path):
        with Image.open(lab_path) as im:
            lab = np.asarray(im, np.int32)
    return img, lab


@dataclasses.dataclass
class VOCSpec(_CanvasSpec):
    root: str = ""
    canvas_hw: Tuple[int, int] = (512, 512)

    def _decode(self, sample_id: str):
        return _read_pair(
            os.path.join(self.root, "JPEGImages", f"{sample_id}.jpg"),
            os.path.join(self.root, "SegmentationClassAug", f"{sample_id}.png"))


@dataclasses.dataclass
class CityscapesSpec(_CanvasSpec):
    root: str = ""
    mode: str = "train"  # train | val
    canvas_hw: Tuple[int, int] = (1024, 2048)

    def _cache_key(self, sample_id: str) -> str:
        return f"{self.mode}_{sample_id}"

    def _decode(self, sample_id: str):
        city = sample_id[: sample_id.find("_")]
        lab_id = sample_id[:-len("_leftImg8bit")] + "_gtFine_trainIds"
        return _read_pair(
            os.path.join(self.root, "leftImg8bit", self.mode, city, f"{sample_id}.png"),
            os.path.join(self.root, "gtFine", self.mode, city, f"{lab_id}.png"))


@dataclasses.dataclass
class SyntheticSpec(_CanvasSpec):
    """Deterministic random data with the record interface (tests, smoke runs)."""

    num_classes: int = 21
    canvas_hw: Tuple[int, int] = (512, 512)
    image_hw: Optional[Tuple[int, int]] = None   # default: about canvas-sized

    def _decode(self, sample_id: str):
        # crc32, not hash(): str hashing is salted per interpreter
        seed = zlib.crc32(sample_id.encode()) & 0x7FFFFFFF
        rng = np.random.default_rng(seed)
        if self.image_hw is not None:
            h, w = self.image_hw
        else:
            h = max(int(self.canvas_hw[0] * 0.95), 1)
            w = max(int(self.canvas_hw[1] * 0.75), 1)
        # a learnable task: smooth colour blobs whose quantized brightness is
        # the label
        yy = np.linspace(0, 4 * np.pi, h)[:, None]
        xx = np.linspace(0, 4 * np.pi, w)[None, :]
        ph = rng.random(6) * 2 * np.pi
        fr = rng.random(6) * 1.5 + 0.25
        field = sum(np.sin(fr[i] * yy + ph[i]) * np.cos(fr[i + 3] * xx + ph[i + 3])
                    for i in range(3))
        field = (field - field.min()) / max(float(np.ptp(field)), 1e-6)
        img = np.stack([field, field ** 2, 1.0 - field], axis=-1)
        img = np.clip(img * 255 + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
        lab = np.minimum((field * self.num_classes).astype(np.int32), self.num_classes - 1)
        lab[rng.random((h, w)) < 0.02] = 255
        return img, lab


def build_dataset_specs(name: str, data_dir: str, canvas_hw: Tuple[int, int],
                        num_classes: int = 21, cache_dir: Optional[str] = None):
    """(train_spec, test_spec) for a dataset name (VOC | CityScapes | Synthetic);
    ``cache_dir`` turns on the decoded-raw sample cache."""
    canvas_hw = tuple(canvas_hw)
    if name == "VOC":
        spec = VOCSpec(root=data_dir, canvas_hw=canvas_hw, cache_dir=cache_dir)
        return spec, spec
    if name == "CityScapes":
        return (CityscapesSpec(root=data_dir, mode="train", canvas_hw=canvas_hw,
                               cache_dir=cache_dir),
                CityscapesSpec(root=data_dir, mode="val", canvas_hw=canvas_hw,
                               cache_dir=cache_dir))
    if name == "Synthetic":
        spec = SyntheticSpec(num_classes=num_classes, canvas_hw=canvas_hw, cache_dir=cache_dir)
        return spec, spec
    raise ValueError(f"unknown dataset {name}")
