"""The reference network of a configuration, found by its ``Network.name``.

``networks/<Network.name>.py`` holds the network in plain float32 PyTorch,
its weight rules and its test size; ``benchmark/README.md`` gives the
contract such a file keeps.  A second network is a second file: there is no
list to edit.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path
from types import ModuleType

import torch

__all__ = ["NETWORKS", "network_file", "build_reference"]

NETWORKS = Path(__file__).resolve().parent / "networks"


@functools.lru_cache(maxsize=None)
def _load(path: Path) -> ModuleType:
    name = f"benchmark.reference.networks.{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def network_file(network: dict) -> ModuleType:
    """The module of ``networks/<network["name"]>.py`` (``network``: a
    configuration's ``Network`` group)."""
    path = NETWORKS / f"{network['name']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"reference: no network {network['name']!r}: "
                                f"{path} does not exist")
    return _load(path)


def build_reference(config: dict, device="cpu") -> torch.nn.Module:
    """The reference network of a benchmark configuration (its ``Network``
    group) on ``device``, its tensors uninitialised: the weight maker fills
    them."""
    net = config["Network"]
    module = network_file(net)
    with torch.device(device):
        return module.build(net)
