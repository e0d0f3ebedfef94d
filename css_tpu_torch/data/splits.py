"""Partial-label split protocol, counterpart of ``css_tpu/data/splits.py``.

Splits live in ``<txt_dir>/<label_num>/<seed>/{labeled,unlabeled,valid}_
filename.txt``, one sample id per line.
"""

from __future__ import annotations

import os
from typing import List, Tuple

__all__ = ["read_split_lists"]


def read_split_lists(txt_dir: str, label_num: int, seed: int
                     ) -> Tuple[List[str], List[str], List[str]]:
    root = os.path.join(txt_dir, str(label_num), str(seed))

    def _read(name):
        with open(os.path.join(root, name)) as f:
            return [ln for ln in f.read().splitlines() if ln.strip()]

    return (
        _read("labeled_filename.txt"),
        _read("unlabeled_filename.txt"),
        _read("valid_filename.txt"),
    )
