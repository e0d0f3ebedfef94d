"""Faults planted in the program under test, to show that ``correct`` reads
false for them: by ``calibrate.py`` at a cell's own size on the card, and by
the benchmark's tests at the test size.  The benchmark's runs plant none.

    with planted("k2_zero"):
        ...   # the program's step, with the fault, for the block's length

* ``unchanged_state``: a training step that returns its state unchanged;
* ``half_batch``: a step that sees the first half of the labeled and of the
  unlabeled batch, with their draws, and takes its means over that half;
* ``k2_zero``: the contrastive negatives' backward kernel (K2) gives a zero
  gradient for the anchors;
* ``class_dropped``: the live-row compaction reports no live row for the
  first class that has members in the batch and live rows, so K1 sums no
  negative for it;
* ``proto_ema_swapped``: the prototypes' moving average keeps (1 - alpha)
  of the old prototype and takes alpha of the batch mean, where it should
  keep alpha.

Each is planted by replacing a public name of the program's modules for the
block's length, and put back after it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["FAULTS", "planted"]


def _unchanged_step(make):
    def build(cfg):
        def step(state, batch, draws, weight, use_rep_labels=False):
            return state, {k: torch.zeros(()) for k in ("total", "sup", "unsup", "contrast")}
        return step
    return build


def _half_batch_step(make):
    """The program's step, given the first half of each batch and its draws."""
    def build(cfg):
        real = make(cfg)

        def step(state, batch, draws, weight, use_rep_labels=False):
            b = batch["l_image"].shape[0]
            h = b // 2
            per_image = draws.contrast.tie.shape[0] // (2 * b)
            keep = torch.cat([torch.arange(h * per_image),
                              b * per_image + torch.arange(h * per_image)])
            keep = keep.to(draws.contrast.tie.device)

            def cut(d, rows=False):
                return dataclasses.replace(d, **{
                    f.name: (None if getattr(d, f.name) is None else
                             getattr(d, f.name)[..., keep] if rows and f.name in ("tie", "u")
                             else getattr(d, f.name) if rows else getattr(d, f.name)[:h])
                    for f in dataclasses.fields(d)})

            half = dataclasses.replace(
                draws, l_aug=cut(draws.l_aug), u_crop=cut(draws.u_crop),
                t_crop=cut(draws.t_crop), u_aug=cut(draws.u_aug), mix=cut(draws.mix),
                contrast=cut(draws.contrast, rows=True))
            return real(state, {k: v[:h] for k, v in batch.items()}, half, weight,
                        use_rep_labels)
        return step
    return build


def _k2_zero(real):
    def softsum(a, r, idx, wv, n_live, inv_temp):
        return real(a.detach(), r, idx, wv, n_live, inv_temp)
    return softsum


def _class_dropped(real):
    def live_rows(p_over_cnt, masked_cls, g, u=None):
        idx, wv, n_live = real(p_over_cnt, masked_cls, g, u)
        c = p_over_cnt.shape[0]
        present = torch.bincount(masked_cls.long(), minlength=c + 1)[:c] > 0
        some = torch.nonzero(present & (n_live > 0))
        if some.numel():
            n_live = n_live.clone()
            n_live[int(some[0, 0])] = 0
        return idx, wv, n_live
    return live_rows


def _proto_ema_swapped(real):
    def loss(rep, label_onehot, mask, prob, prototypes, *args, **kwargs):
        value, new = real(rep, label_onehot, mask, prob, prototypes, *args, **kwargs)
        alpha = float(kwargs.get("alpha", 0.99))
        old = prototypes.to(new.dtype)
        moved = (old.abs().sum(1, keepdim=True) > 0) & (new != old).any(1, keepdim=True)
        # new = alpha old + (1 - alpha) mean; the fault: (1 - alpha) old + alpha mean
        mean = (new - alpha * old) / (1.0 - alpha)
        return value, torch.where(moved, (1.0 - alpha) * old + alpha * mean, new)
    return loss


# name -> (module, attribute, wrapper of the attribute's value)
FAULTS = {
    "unchanged_state": ("css_tpu_torch.train.train_step", "make_train_step", _unchanged_step),
    "half_batch": ("css_tpu_torch.train.train_step", "make_train_step", _half_batch_step),
    "k2_zero": ("css_tpu_torch.losses.contrastive", "weighted_exp_softsum_live", _k2_zero),
    "class_dropped": ("css_tpu_torch.losses.contrastive", "class_live_rows", _class_dropped),
    "proto_ema_swapped": ("css_tpu_torch.train.train_step", "prototype_contrastive_loss",
                          _proto_ema_swapped),
}


@contextlib.contextmanager
def planted(name: str):
    import importlib

    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
