"""Seeded initial weights, made on the device in two large calls and handed
to the program's student and teacher and to the reference alike.

Convolution weights are normal with He's fan-out variance (torchvision's
ResNet initialisation, which the recipe uses for every layer it does not
load); the heads' final 1x1 convolutions and their biases are uniform in
+-1/sqrt(fan in) (PyTorch's default for a convolution); BatchNorm scales
are 1 and shifts 0, running means 0 and variances 1.  A tensor of another
name raises, so a layout the benchmark does not know is never filled
half-way.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch

from benchmark import seeds

__all__ = ["fill_", "layout"]


def _kind(name: str, t: torch.Tensor) -> str:
    if name.endswith("bn.weight") or name.endswith("running_var"):
        return "one"
    if name.endswith("bn.bias") or name.endswith("running_mean"):
        return "zero"
    if name.endswith("out.weight") or name.endswith("out.bias"):
        return "uniform"
    if name.endswith("conv.weight") and t.dim() == 4:
        return "normal"
    raise ValueError(f"weights: no rule for {name} {tuple(t.shape)}")


def layout(module: torch.nn.Module):
    """(name, shape) of every parameter and buffer, sorted by name."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    return sorted((k, tuple(v.shape)) for k, v in named)


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int) -> None:
    """Writes the seed's weights into every parameter and buffer of
    ``module``, on the module's device."""
    named: Iterable[Tuple[str, torch.Tensor]] = sorted(
        list(module.named_parameters()) + list(module.named_buffers()), key=lambda kv: kv[0])
    named = list(named)
    kinds = [_kind(k, v) for k, v in named]
    dev = named[0][1].device
    g = seeds.generator(dev, seed, seeds.WEIGHTS)
    normal = torch.randn(sum(v.numel() for (_, v), k in zip(named, kinds) if k == "normal"),
                         generator=g, device=dev)
    uniform = torch.rand(sum(v.numel() for (_, v), k in zip(named, kinds) if k == "uniform"),
                         generator=g, device=dev)
    fan_in = {k[:-len("weight")]: v.shape[1] * v.shape[2] * v.shape[3]
              for k, v in named if k.endswith("out.weight")}
    on, ou = 0, 0
    for (name, t), kind in zip(named, kinds):
        n = t.numel()
        if kind == "one":
            t.fill_(1.0)
        elif kind == "zero":
            t.zero_()
        elif kind == "normal":
            fan_out = t.shape[0] * t.shape[2] * t.shape[3]
            t.copy_(normal[on:on + n].view(t.shape) * math.sqrt(2.0 / fan_out))
            on += n
        else:
            bound = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0] + "."])
            t.copy_((uniform[ou:ou + n].view(t.shape) * 2.0 - 1.0) * bound)
            ou += n
