"""Host data pipeline: dataset specs, split lists and the batch loader."""

from css_tpu_torch.data.datasets import (CityscapesSpec, SyntheticSpec, VOCSpec,
                                         build_dataset_specs)
from css_tpu_torch.data.loader import BatchLoader, InfiniteLoader
from css_tpu_torch.data.splits import read_split_lists

__all__ = ["CityscapesSpec", "SyntheticSpec", "VOCSpec", "build_dataset_specs",
           "BatchLoader", "InfiniteLoader", "read_split_lists"]
