"""Shared pieces of the benchmark's tests: the repository root on the path,
a tiny configuration (the network file's ``TINY`` at 32x32) of each cell,
and the ``card`` fixture that skips a test without a CUDA card."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(config: dict, dtype: str = "float32") -> dict:
    """``config`` at test size: the network file's ``TINY`` overrides of the
    ``Network`` group, 6 classes, 32x32 crops of 40x40 canvases, batches of
    4, few records."""
    from benchmark.reference.model import network_file

    c = copy.deepcopy(config)
    c["Network"].update(num_class=6, output_dim=16, dtype=dtype)
    c["Network"].update(network_file(c["Network"]).TINY)
    c["Dataset"].update(batch_size=4, crop_size=[32, 32], canvas_size=[40, 40])
    c["Loss"].update(num_queries=64, num_negatives=512, ohem_min_kept_per_image=200)
    c["Records"] = {"image_hw": [30, 40], "splits": {"labeled": 12, "unlabeled": 12,
                                                     "validation": 5}}
    return c


def tiny_cell(name: str, dtype: str = "float32"):
    from benchmark.spec import load_cell

    cell = load_cell(name)
    cell.config = tiny(cell.config, dtype)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
