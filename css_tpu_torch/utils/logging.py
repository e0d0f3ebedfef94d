"""Logging: stdout plus an optional log file, and optional TensorBoard
scalars, from rank 0 only; counterpart of ``css_tpu/utils/logging.py``."""

from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["Logger", "ScalarWriter"]


class Logger:
    """Prints and appends to ``log_file`` on rank 0; silent on other ranks."""

    def __init__(self, log_file: Optional[str] = None, rank: int = 0):
        self.rank = rank
        self._fh = None
        if log_file and rank == 0:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            self._fh = open(log_file, "a")

    def info(self, msg: str) -> None:
        if self.rank != 0:
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        print(line, flush=True)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ScalarWriter:
    """TensorBoard scalars from rank 0; a no-op on other ranks and where
    tensorboardX is not installed."""

    def __init__(self, log_dir: Optional[str], rank: int = 0):
        self._w = None
        if log_dir and rank == 0:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._w = SummaryWriter(log_dir)

    def scalars(self, step: int, values: dict) -> None:
        if self._w is None:
            return
        for k, v in values.items():
            self._w.add_scalar(k, float(v), step)
        self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
