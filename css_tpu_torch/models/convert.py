"""Flax -> PyTorch weight conversion for the port's ``DeepLabV3PlusDual``.

``from_jax_variables`` takes the Flax ``params`` and ``batch_stats`` pytrees
(nested dicts of numpy arrays) and returns the port's state dict.  The port
names its modules after the Flax module paths, so the mapping is by name and
covers any trunk (ResNet-101 or the tiny test trunk):

* ``.../kernel`` (HWIO) -> ``.../weight`` (OIHW);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
* batch stats ``mean``/``var`` -> ``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_variables"]

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
