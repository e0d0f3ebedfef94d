"""The random draws of one training step and of one eval batch, made again
from their generator for the reference.

The stream of the recipe's draws in their order (per augmentation call: the
scale ratio, the crop uniforms, then for the photometric calls the jitter
flag, the four factors, the op order, the blur flag, the sigma and the flip
flag; CutMix's box width and corner; the contrastive loss's tie-break keys,
anchor uniforms and thinning uniforms), drawn from a ``torch.Generator``
that the benchmark seeds (``benchmark/seeds.py``).  Each draw is a dict of
tensors.  Imports nothing of the program under test.
"""

from __future__ import annotations

import torch

BRIGHTNESS = CONTRAST = SATURATION = (0.75, 1.25)
HUE = (-0.25, 0.25)
SIGMA = (0.15, 1.15)


def _u(g, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def augment(g, b, scale_range, photometric):
    d = {"ratio": _u(g, (b,), *scale_range), "u_y": _u(g, (b,)), "u_x": _u(g, (b,))}
    if photometric:
        d["do_jitter"] = _u(g, (b,)) > 0.2
        d["jitter"] = torch.stack([_u(g, (b,), *r)
                                   for r in (BRIGHTNESS, CONTRAST, SATURATION, HUE)], dim=1)
        d["jitter_order"] = torch.argsort(_u(g, (b, 4)), dim=1)
        d["do_blur"] = _u(g, (b,)) > 0.5
        d["sigma"] = _u(g, (b,), *SIGMA)
        d["do_flip"] = _u(g, (b,)) > 0.5
    return d


def step(g, num_classes, crop_hw, scale_range, l_batch, u_batch, rows, num_queries):
    """The ``ori`` / CutMix / ``sampled_pallas`` step's draws, in stream order."""
    d = {"l_aug": augment(g, l_batch, scale_range, True),
         "u_crop": augment(g, u_batch, (1.0, 1.0), False),
         "t_crop": augment(g, u_batch, scale_range, False),
         "u_aug": augment(g, u_batch, (1.0, 1.0), True)}
    w = crop_hw[1]
    d["mix"] = {"cut_w": torch.randint(int(w / 2 + 1), w, (u_batch,), generator=g,
                                       device=g.device),
                "u_x": _u(g, (u_batch,)), "u_y": _u(g, (u_batch,))}
    d["contrast"] = {"tie": torch.randint(0, 1 << 24, (rows,), generator=g, device=g.device,
                                          dtype=torch.int32),
                     "u1": _u(g, (num_classes, num_queries)),
                     "u": _u(g, (num_classes, rows))}
    return d
