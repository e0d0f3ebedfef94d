"""Every random draw one train step consumes, as tensors.

The JAX step derives its randomness from keys inside itself; the port's
functions instead take their draws as tensors, which keeps each of them a
pure function of its inputs and lets a test feed both packages the same
draws.  ``StepDraws`` gathers them; ``sample_step_draws`` fills one from a
``torch.Generator``, on the generator's device.

Per ``batch_transform`` call (``AugmentDraws``, one entry per image): the
scale ratio and the crop-offset uniforms, and for the photometric calls the
jitter flag, the four jitter factors, the jitter op order, the blur flag and
sigma, and the flip flag.  Mixing (``MixDraws``): box width and corner
uniforms for CutOut and CutMix, per-slot scores for ClassMix, nothing for
``none``.  Contrastive loss (``ContrastDraws``), as the negative mode
consumes them: 24-bit tie-break keys and anchor uniforms in every mode, and
``sampled_pallas``: the uniforms of the thinned multiplicities; ``sampled``:
tie-break keys for the order of all member pixels and the class and pixel
uniforms of every anchor's negatives; ``expected``/``expected_pallas``:
nothing more.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from css_tpu_torch.losses.contrastive import NEGATIVE_MODES
from css_tpu_torch.utils.profiling import span

__all__ = ["AugmentDraws", "MixDraws", "ContrastDraws", "StepDraws", "NEGATIVE_MODES",
           "sample_augment_draws", "sample_mix_draws", "sample_contrast_draws",
           "sample_step_draws"]

BRIGHTNESS = CONTRAST = SATURATION = (0.75, 1.25)
HUE = (-0.25, 0.25)
SIGMA = (0.15, 1.15)


class _Draws:
    def as_kwargs(self) -> dict:
        """The fields as keyword arguments of the function that consumes
        them (no copies, unlike ``dataclasses.asdict``)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass
class AugmentDraws(_Draws):
    ratio: torch.Tensor                          # [B] f32 scale ratio
    u_y: torch.Tensor                            # [B] f32 crop-offset uniforms
    u_x: torch.Tensor
    do_jitter: Optional[torch.Tensor] = None     # [B] bool (photometric calls)
    jitter: Optional[torch.Tensor] = None        # [B, 4] f32 factors b, c, s, h
    jitter_order: Optional[torch.Tensor] = None  # [B, 4] int64 permutations
    do_blur: Optional[torch.Tensor] = None       # [B] bool
    sigma: Optional[torch.Tensor] = None         # [B] f32
    do_flip: Optional[torch.Tensor] = None       # [B] bool


@dataclasses.dataclass
class MixDraws(_Draws):
    cut_w: Optional[torch.Tensor] = None    # [B] int64 box widths in [W/2 + 1, W)
    u_x: Optional[torch.Tensor] = None      # [B] f32 corner uniforms
    u_y: Optional[torch.Tensor] = None
    scores: Optional[torch.Tensor] = None   # [B, C + 1] f32 ClassMix slot scores


@dataclasses.dataclass
class ContrastDraws(_Draws):
    tie: torch.Tensor                       # [N] int32, 24 random bits (hard-anchor order)
    u1: torch.Tensor                        # [C, Q] f32 anchor uniforms
    u: Optional[torch.Tensor] = None        # [C, N] f32 thinning uniforms (sampled_pallas)
    tie_all: Optional[torch.Tensor] = None  # [N] int32, 24 random bits (sampled: member order)
    u_cls: Optional[torch.Tensor] = None    # [C, Q * G] f32 negative-class uniforms (sampled)
    u_pix: Optional[torch.Tensor] = None    # [C, Q * G] f32 negative-pixel uniforms (sampled)


@dataclasses.dataclass
class StepDraws:
    l_aug: AugmentDraws    # labeled batch: scale/crop + photometric + flip
    u_crop: AugmentDraws   # unlabeled base crop at scale 1
    t_crop: AugmentDraws   # pseudo-labeled batch: scale/crop at the config scale
    u_aug: AugmentDraws    # after mixing: photometric + flip at scale 1
    mix: MixDraws
    contrast: ContrastDraws


def _uniform(g: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def sample_augment_draws(g: torch.Generator, b: int, scale_range: Tuple[float, float],
                         photometric: bool) -> AugmentDraws:
    draws = AugmentDraws(ratio=_uniform(g, (b,), *scale_range), u_y=_uniform(g, (b,)),
                         u_x=_uniform(g, (b,)))
    if photometric:
        draws.do_jitter = _uniform(g, (b,)) > 0.2
        draws.jitter = torch.stack([_uniform(g, (b,), *r)
                                    for r in (BRIGHTNESS, CONTRAST, SATURATION, HUE)], dim=1)
        draws.jitter_order = torch.argsort(_uniform(g, (b, 4)), dim=1)
        draws.do_blur = _uniform(g, (b,)) > 0.5
        draws.sigma = _uniform(g, (b,), *SIGMA)
        draws.do_flip = _uniform(g, (b,)) > 0.5
    return draws


def sample_mix_draws(g: torch.Generator, mode: str, b: int, crop_w: int,
                     num_classes: int) -> MixDraws:
    """What ``mix_batch(mode=mode)`` consumes for ``b`` images."""
    if mode in ("cutout", "cutmix"):
        return MixDraws(
            cut_w=torch.randint(int(crop_w / 2 + 1), crop_w, (b,), generator=g, device=g.device),
            u_x=_uniform(g, (b,)), u_y=_uniform(g, (b,)))
    if mode == "classmix":
        return MixDraws(scores=_uniform(g, (b, num_classes + 1)))
    return MixDraws()


def _tie(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(0, 1 << 24, (n,), generator=g, device=g.device, dtype=torch.int32)


def sample_contrast_draws(g: torch.Generator, mode: str, num_classes: int, num_queries: int,
                          num_negatives: int, rows: int) -> ContrastDraws:
    """What ``prototype_contrastive_loss(negative_mode=mode)`` consumes for a
    table of ``rows`` pixels."""
    if mode not in NEGATIVE_MODES:
        raise ValueError(f"unknown negative_mode {mode!r} (one of {NEGATIVE_MODES})")
    draws = ContrastDraws(tie=_tie(g, rows), u1=_uniform(g, (num_classes, num_queries)))
    if mode == "sampled_pallas":
        draws.u = _uniform(g, (num_classes, rows))
    elif mode == "sampled":
        draws.tie_all = _tie(g, rows)
        draws.u_cls = _uniform(g, (num_classes, num_queries * num_negatives))
        draws.u_pix = _uniform(g, (num_classes, num_queries * num_negatives))
    return draws


def sample_step_draws(generator: torch.Generator, cfg, l_batch: int, u_batch: int,
                      rep_pixels: int) -> StepDraws:
    """Draws for one step of ``cfg`` (a ``StepConfig``): ``l_batch`` labeled
    and ``u_batch`` unlabeled images, ``rep_pixels`` = pixels of the
    representation map over both batches (the contrastive table's N).  The
    strategies draw alike: ``mix`` and ``cross`` add only a deterministic
    teacher forward."""
    g = generator
    with span("css.draws"):
        return StepDraws(
            l_aug=sample_augment_draws(g, l_batch, cfg.scale_range, True),
            u_crop=sample_augment_draws(g, u_batch, (1.0, 1.0), False),
            t_crop=sample_augment_draws(g, u_batch, cfg.scale_range, False),
            u_aug=sample_augment_draws(g, u_batch, (1.0, 1.0), True),
            mix=sample_mix_draws(g, cfg.mix_mode, u_batch, cfg.crop_hw[1], cfg.num_classes),
            contrast=sample_contrast_draws(g, cfg.negative_mode, cfg.num_classes,
                                           cfg.num_queries, cfg.num_negatives, rep_pixels),
        )
