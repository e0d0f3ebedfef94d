"""ASPP head, counterpart of ``css_tpu/models/aspp.py`` (NCHW inside).

A 1x1 branch, three dilated 3x3 branches and a global-pool branch,
concatenated (5 x 256 channels) and projected by a 1x1 conv.  The pooled map
is 1x1, so its upsample is a broadcast, and its BatchNorm sees one value per
image and channel (n = B/G per group).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from css_tpu_torch.models.resnet import ConvBN

__all__ = ["ASPP"]


class ASPP(nn.Module):
    def __init__(self, in_ch: int, atrous_rates: Sequence[int] = (12, 24, 36),
                 features: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1x1 = ConvBN(in_ch, features, 1, dtype=dtype)
        self.atrous_names = []
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"atrous{i}", ConvBN(in_ch, features, 3, 1, rate, dtype=dtype))
            self.atrous_names.append(f"atrous{i}")
        self.pool_conv = ConvBN(in_ch, features, 1, dtype=dtype)
        self.project = ConvBN(features * (2 + len(atrous_rates)), features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        branches = [self.conv1x1(x, groups)]
        branches += [getattr(self, name)(x, groups) for name in self.atrous_names]
        # mean accumulated in f32 and returned in the compute dtype, as jnp.mean
        pooled = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        pooled = self.pool_conv(pooled, groups)
        branches.append(pooled.expand_as(branches[0]))
        return self.project(torch.cat(branches, dim=1), groups)
