"""The benchmark's data: seeded synthetic records in the dataset's canvas
layout.

A record is an image of the dataset's size (VOC about 375x500, Cityscapes
1024x2048) in a canvas (uint8, padded 0) and a label map (int32, padded 255
= ignore): a smooth field whose quantised level is the class, coloured by a
palette of the record's own, with uint8 noise and 2% of the pixels ignored.
It is a function of its id alone, and the ids carry the run's seed, so a
seed gives the same records to the program (through its ``BatchLoader``,
which takes any object with ``canvas_hw`` and ``load_into``) and to the
reference.  A record costs a few milliseconds of numpy (a Cityscapes one
35-45 ms), less than decoding a file of that size.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

__all__ = ["RecordMaker", "split_ids"]


class RecordMaker:
    def __init__(self, canvas_hw: Tuple[int, int], image_hw: Tuple[int, int], num_classes: int):
        self.canvas_hw = tuple(canvas_hw)
        self.image_hw = tuple(image_hw)
        self.num_classes = num_classes
        if self.image_hw[0] > self.canvas_hw[0] or self.image_hw[1] > self.canvas_hw[1]:
            raise ValueError(f"records of {self.image_hw} do not fit the canvas {self.canvas_hw}")

    def make(self, sample_id: str):
        """(image uint8 [h, w, 3], label int32 [h, w])."""
        rng = np.random.default_rng(zlib.crc32(sample_id.encode()))
        h, w = self.image_hw
        ph = rng.random(6, dtype=np.float32) * np.float32(2 * np.pi)
        fr = rng.random(6, dtype=np.float32) * np.float32(1.5) + np.float32(0.25)
        yy = np.linspace(0, 4 * np.pi, h, dtype=np.float32)
        xx = np.linspace(0, 4 * np.pi, w, dtype=np.float32)
        field = sum(np.sin(fr[i] * yy + ph[i])[:, None] * np.cos(fr[i + 3] * xx + ph[i + 3])
                    for i in range(3))
        field -= field.min()
        field *= np.float32(255.0 / max(float(field.max()), 1e-6))
        level = field.astype(np.uint16)
        # each record its own palette: a gain (of 256) and an offset a channel;
        # uint16 throughout (every product stays below 2^16)
        gain = rng.integers(64, 224, 3).astype(np.uint16)
        offset = rng.integers(0, 256 - gain.astype(np.int64) - 16 + 1).astype(np.uint16)
        image = np.empty((h, w, 3), np.uint8)
        image[..., 0] = (level * gain[0] >> 8) + offset[0]
        image[..., 1] = ((level * level >> 8) * gain[1] >> 8) + offset[1]
        image[..., 2] = ((np.uint16(255) - level) * gain[2] >> 8) + offset[2]
        # uint8 noise and 2% ignored pixels, from 64-row blocks repeated down
        reps = -(-h // 64)
        image += np.tile(rng.integers(0, 17, (64, w, 3), dtype=np.uint8), (reps, 1, 1))[:h]
        label = (level.astype(np.int32) * self.num_classes) >> 8
        ignore = np.tile(rng.integers(0, 50, (64, w), dtype=np.uint8) == 0, (reps, 1))[:h]
        label[ignore] = 255
        return image, label

    def load_into(self, sample_id: str, icanvas: np.ndarray, lcanvas: np.ndarray) -> np.ndarray:
        """The loader's interface: the record pasted into the given canvases
        (pre-filled 0 and 255); returns its (h, w)."""
        image, label = self.make(sample_id)
        h, w = self.image_hw
        icanvas[:h, :w] = image
        lcanvas[:h, :w] = label
        return np.asarray([h, w], np.int32)

    def batch(self, ids: List[str]) -> dict:
        """A batch of these ids as the loader assembles it."""
        b = len(ids)
        ch, cw = self.canvas_hw
        image = np.zeros((b, ch, cw, 3), np.uint8)
        label = np.full((b, ch, cw), 255, np.int32)
        valid_hw = np.stack([self.load_into(s, image[i], label[i]) for i, s in enumerate(ids)])
        return dict(image=image, label=label, valid_hw=valid_hw, valid=np.ones(b, bool))


def split_ids(seed: int, split: str, count: int) -> List[str]:
    """The ids of a split (``l`` labeled, ``u`` unlabeled)."""
    return [f"{seed}-{split}{i}" for i in range(count)]
