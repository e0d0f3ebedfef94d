"""Seeded initial weights, made on the device in a few large calls and handed
to the program's student and teacher and to the reference alike.

The reference network's file (``reference/networks/<Network.name>.py``)
gives each tensor its kind, by ``weight_kind(name, tensor)``:

* ``"one"``, ``"zero"``: filled;
* ``"uniform"``: uniform in +-1/sqrt(fan in), PyTorch's default for a
  convolution or a linear layer; a bias takes the fan in of its module's
  weight (the name with ``bias`` replaced by ``weight``);
* ``"he_fan_out"`` or ``("he_fan_out", groups)``: normal with variance
  2 / (C_out * k^2 // groups), He's fan-out rule (torchvision's ResNet,
  SegFormer's convolutions);
* ``("trunc_normal", std)``: normal with that std, cut to [-2, 2]
  (absolute, timm's ``trunc_normal_`` default), drawn as timm draws it, by
  the inverse of the normal CDF of a uniform.

A tensor without a rule raises, so a layout the benchmark does not know is
never filled half-way.  The draws: the He normals in one call, the
uniforms in a second, the truncated normals' uniforms in a third, each in
the order of the sorted names.
"""

from __future__ import annotations

import math

import torch

from benchmark import seeds
from benchmark.reference.model import network_file

__all__ = ["fill_", "layout"]

_KINDS = ("one", "zero", "uniform", "he_fan_out", "trunc_normal")


def _kinds(named, network: dict):
    """The network file's rule for each (name, tensor), as (kind, *args)."""
    rule = network_file(network).weight_kind
    out = []
    for name, t in named:
        kind = rule(name, t)
        kind = (kind,) if isinstance(kind, str) else tuple(kind)
        if kind[0] not in _KINDS:
            raise ValueError(f"weights: {name}: no kind {kind[0]!r} (one of {', '.join(_KINDS)})")
        out.append(kind)
    return out


def _named(module: torch.nn.Module):
    return sorted(list(module.named_parameters()) + list(module.named_buffers()),
                  key=lambda kv: kv[0])


def layout(module: torch.nn.Module):
    """(name, shape) of every parameter and buffer, sorted by name."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    return sorted((k, tuple(v.shape)) for k, v in named)


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, network: dict) -> None:
    """Writes the seed's weights into every parameter and buffer of
    ``module``, on the module's device, by the rules of ``network``'s file."""
    named = _named(module)
    kinds = _kinds(named, network)
    dev = named[0][1].device
    g = seeds.generator(dev, seed, seeds.WEIGHTS)

    def count(kind):
        return sum(v.numel() for (_, v), k in zip(named, kinds) if k[0] == kind)

    # the order of these calls is the weights' bit pattern: new kinds draw after them
    normal = torch.randn(count("he_fan_out"), generator=g, device=dev)
    uniform = torch.rand(count("uniform"), generator=g, device=dev)
    trunc = torch.rand(count("trunc_normal"), generator=g, device=dev)
    tensors = dict(named)
    on = ou = ot = 0
    for (name, t), (kind, *args) in zip(named, kinds):
        n = t.numel()
        if kind == "one":
            t.fill_(1.0)
        elif kind == "zero":
            t.zero_()
        elif kind == "he_fan_out":
            groups = args[0] if args else 1
            fan_out = t.shape[0] * math.prod(t.shape[2:]) // groups
            t.copy_(normal[on:on + n].view(t.shape) * math.sqrt(2.0 / fan_out))
            on += n
        elif kind == "uniform":
            weight = tensors[name.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / math.sqrt(math.prod(weight.shape[1:]))
            t.copy_((uniform[ou:ou + n].view(t.shape) * 2.0 - 1.0) * bound)
            ou += n
        else:
            t.copy_(_trunc_normal(trunc[ot:ot + n], *args).view(t.shape))
            ot += n


def _trunc_normal(u: torch.Tensor, std: float):
    """timm's ``trunc_normal_`` (mean 0, cut at +-2) of the uniforms ``u`` in
    [0, 1): the inverse normal CDF of a uniform between the CDF's values at
    the cuts, in float64 and with half a float32 step added, so that no draw
    lands on the CDF's end, where the inverse is infinite."""
    def cdf(x):
        return (1.0 + math.erf(x / std / math.sqrt(2.0))) / 2.0

    lo, hi = cdf(-2.0), cdf(2.0)
    p = lo + (u.double() + 2.0 ** -25) * (hi - lo)
    x = torch.erfinv(2.0 * p - 1.0) * (std * math.sqrt(2.0))
    return x.clamp_(-2.0, 2.0).float()
