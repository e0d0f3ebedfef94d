"""Flax -> PyTorch weight conversion for the port's ``DeepLabV3PlusDual``.

``from_jax_variables`` takes the Flax ``params`` and ``batch_stats`` pytrees
(nested dicts of numpy arrays) and returns the port's state dict.  The port
names its modules after the Flax module paths, so the mapping is by name and
covers any trunk (ResNet-101 or the tiny test trunk):

* ``.../kernel`` (HWIO) -> ``.../weight`` (OIHW);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
* batch stats ``mean``/``var`` -> ``running_mean``/``running_var``.

``load_torchvision_backbone`` loads a torchvision-layout ResNet state dict
into the port's trunk; both sides are OIHW, so only the names change:

* plain stem: torchvision ``resnet101()`` (``conv1``/``bn1``/``layerK.B.*``,
  the reference's ImageNet trunk);
* deep stem: the reference's ``ResNet_Stem`` checkpoint, whose stem is the
  sequence ``conv1.{0,1,3,4,6}`` + ``bn1`` (``stem1``: ``conv1.0``/``conv1.1``,
  ``stem2``: ``conv1.3``/``conv1.4``, ``stem3``: ``conv1.6``/``bn1``) and whose
  multi-grid ``layer4.{0,1,2}`` are the port's ``layer{4,5,6}_0``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import re

import numpy as np
import torch

__all__ = ["from_jax_variables", "load_torchvision_backbone"]

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for the Flax variables ``(params, batch_stats)``."""
    sd: Dict[str, torch.Tensor] = {}
    for names, tree in ((_PARAM_NAMES, params), (_STAT_NAMES, batch_stats)):
        for path, value in _leaves(tree):
            if path[-1] not in names:
                raise KeyError(f"unexpected Flax leaf {'/'.join(path)}")
            if path[-1] == "kernel":
                value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
            key = ".".join(path[:-1] + (names[path[-1]],))
            sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


_BLOCK_KEY = re.compile(r"^layer(\d+)_(\d+)\.(conv[123]|downsample)\.(conv|bn)\.(.+)$")


_STEMS = {   # the port's stem module -> torchvision-layout (conv, BN) prefixes
    "stem": ("conv1", "bn1"),
    "stem1": ("conv1.0", "conv1.1"),
    "stem2": ("conv1.3", "conv1.4"),
    "stem3": ("conv1.6", "bn1"),
}


def _torchvision_key(key: str) -> str:
    """The torchvision-layout name of the port's trunk entry ``key``:
    ``stem.conv.weight`` -> ``conv1.weight``, ``stem2.bn.bias`` ->
    ``conv1.4.bias``, ``layer3_4.conv2.bn.running_var`` ->
    ``layer3.4.bn2.running_var``, ``layer1_0.downsample.conv.weight`` ->
    ``layer1.0.downsample.0.weight``, ``layer6_0.conv1.conv.weight`` (the
    third multi-grid block) -> ``layer4.2.conv1.weight``."""
    stem, _, rest = key.partition(".")
    if stem in _STEMS:
        part, leaf = rest.split(".", 1)
        return f"{_STEMS[stem][0 if part == 'conv' else 1]}.{leaf}"
    m = _BLOCK_KEY.match(key)
    if m is None:
        raise KeyError(f"no torchvision name for trunk entry {key}")
    stage, block, unit, part, leaf = m.groups()
    stage, block = int(stage), int(block)
    if stage > 4:   # multi-grid: single-block stages 5, 6 continue layer4
        stage, block = 4, block + stage - 4
    if unit == "downsample":
        name = f"downsample.{0 if part == 'conv' else 1}"
    else:
        name = unit if part == "conv" else f"bn{unit[-1]}"
    return f"layer{stage}.{block}.{name}.{leaf}"


def load_torchvision_backbone(sd: Mapping[str, torch.Tensor],
                              model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Loads the torchvision-layout ResNet state dict ``sd`` into
    ``model.backbone`` (plain or deep stem); returns the trunk's state dict
    under the port's names.  Keys of ``sd`` outside the trunk (``fc.*``,
    ``num_batches_tracked``) are ignored; a missing one raises KeyError."""
    mapped = {}
    for key in model.backbone.state_dict():
        tv_key = _torchvision_key(key)
        if tv_key not in sd:
            raise KeyError(f"{tv_key} (for backbone.{key}) is not in the state dict")
        mapped[key] = torch.as_tensor(np.asarray(sd[tv_key]), dtype=torch.float32)
    model.backbone.load_state_dict(mapped, strict=True)
    return mapped
