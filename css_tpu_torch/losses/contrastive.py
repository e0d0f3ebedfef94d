"""Pixel-prototype contrastive loss in the four negative modes, counterpart
of ``css_tpu/losses/contrastive.py``.

Per class c, with prototypes updated by the EMA of the class means:
  * anchors: Q hard pixels of c (prob_c below the strong threshold), drawn
    uniformly with replacement through a per-class random order;
  * negatives, from the classes other than c that have pixels, each class
    with the probability p = softmax of prototype similarity / temp:
    - ``sampled_pallas``: the multiset sum over pixels n of
      m_n exp(<a, r_n> / temp), with thinned multiplicities m drawn around
      lam_n = G p(class(n)) / count(class(n)), through K1/K2 (every class's
      multiplicities built and compacted in one launch before the class
      loop, ``class_live_rows``);
    - ``sampled``: G negatives per anchor, the class by inverse CDF and the
      pixel uniformly within it, read from the table sorted by class;
    - ``expected``: the exact expectation of the sampled sum, G times the
      weighted sum over all member pixels with weights w_n =
      p(class(n)) / count(class(n)), as a plain product;
    - ``expected_pallas``: the same sum through K1/K2 (dense weights,
      compacted for every class at once as in ``sampled_pallas``);
  * InfoNCE with the own prototype as the positive.
All C classes run every step; classes without a hard anchor or without
pixels contribute 0.  The loss is the sum over classes divided by the number
of locally valid classes, or 0 when fewer than two are valid.  ``sampled``
and ``expected`` recompute each class's loss in backward
(``torch.utils.checkpoint``), as the JAX loss does, so that the [Q, G, D]
negatives or the [Q, N] exponentials of one class are all that is kept.

``distributed`` True: the prototype update takes the per-class sums and
counts over all ranks (one all-reduce of a [C, D + 1] tensor); anchors,
negatives and the valid-class count stay per rank, as in the JAX loss.

The random inputs arrive as tensors (``ContrastDraws`` in train/draws.py):
24-bit tie-break keys ``tie`` [N] and anchor uniforms ``u1`` [C, Q] in every
mode; ``sampled_pallas`` adds the thinning uniforms ``u`` [C, N]; ``sampled``
adds the keys ``tie_all`` [N] of the order of all member pixels and the
negatives' class and pixel uniforms ``u_cls``, ``u_pix`` [C, Q * G].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from css_tpu_torch.ops.kernels.contrastive_kernels import (class_live_rows,
                                                          weighted_exp_softsum_live)
from css_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["prototype_contrastive_loss", "update_prototypes", "grouped_random_order",
           "l2_normalize", "NEGATIVE_MODES"]

NEGATIVE_MODES = ("sampled_pallas", "sampled", "expected", "expected_pallas")
_NEEDS = {"sampled_pallas": ("u",), "sampled": ("tie_all", "u_cls", "u_pix"),
          "expected": (), "expected_pallas": ()}


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def _class_onehot(cls_id, member, num_classes):
    """[N, C] f32 one-hot of the member pixels' classes (non-members all 0)."""
    masked = torch.where(member, cls_id, torch.full_like(cls_id, num_classes))
    return F.one_hot(masked.long(), num_classes + 1)[:, :num_classes].float()


def grouped_random_order(cls_id: torch.Tensor, member: torch.Tensor, tie: torch.Tensor,
                         num_classes: int):
    """Random per-class ordering of pixel ids: ``(order [N], counts [C],
    offsets [C])`` with ``order[offsets[c] : offsets[c] + counts[c]]`` a
    random permutation of the member pixels of class c.

    Sorts one packed int32 key (class << 24 | 24-bit ``tie``) stably, as
    ``lax.sort`` does, so equal keys keep pixel order.
    """
    if num_classes >= 128:
        raise ValueError(
            f"num_classes={num_classes} exceeds the packed-key capacity "
            "(< 128 classes); widen _grouped_random_order's packing first")
    key = torch.where(member, cls_id, torch.full_like(cls_id, num_classes)).int()
    packed = (key << 24) | tie.int()
    _, order = torch.sort(packed, stable=True)
    # a count of fixed length: bincount sizes its output by the largest key,
    # which the host reads back from the card
    counts = torch.zeros(num_classes + 1, dtype=torch.int64, device=key.device).index_add_(
        0, key.long(), torch.ones_like(key, dtype=torch.int64))[:num_classes]
    offsets = torch.cumsum(counts, 0) - counts
    return order, counts, offsets


def update_prototypes(rep: torch.Tensor, cls_id: torch.Tensor, member: torch.Tensor,
                      prototypes: torch.Tensor, alpha: float, distributed: bool = False):
    """EMA of the per-class means (over all ranks when ``distributed``); a
    class seen for the first time (stored prototype exactly zero) takes the
    mean.  Returns (new [C, D], counts [C])."""
    onehot = _class_onehot(cls_id, member, prototypes.shape[0])
    sums = onehot.T @ rep.detach().float()
    counts = onehot.sum(0)
    if distributed:
        with torch.no_grad():
            both = all_reduce_sum(torch.cat([sums, counts[:, None]], dim=1))
        sums, counts = both[:, :-1], both[:, -1]
    mean = sums / torch.clamp_min(counts[:, None], 1.0)
    never_seen = torch.sum(prototypes, dim=1, keepdim=True) == 0.0
    ema = torch.where(never_seen, mean, alpha * prototypes + (1 - alpha) * mean)
    return torch.where(counts[:, None] > 0, ema, prototypes), counts


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and taken back to f32: a bf16 operand of an
    f32-accumulated product.  Its backward rounds the cotangent to bf16, as
    the transpose of JAX's ``astype(bfloat16)`` does."""
    return x.to(torch.bfloat16).float()


def _sampled_class_loss(a_raw, proto, cdf, u_cls, u_pix, counts, offsets, table, temp: float,
                        num_negatives: int):
    """InfoNCE of one class's Q anchors over G sampled negatives each: the
    class of each negative is #{c : cdf[c] < u_cls}, its row
    ``offsets[class] + floor(u_pix * max(count, 1))`` of the class-sorted
    bf16 ``table``."""
    q, d = a_raw.shape
    num_classes = cdf.shape[0]
    samp = torch.sum(u_cls[:, None] > cdf[None, :], dim=1).clamp(0, num_classes - 1)
    cnt, off = counts[samp], offsets[samp]
    pos = (off + torch.floor(u_pix * torch.clamp_min(cnt, 1.0))).long()
    negs = table[pos].reshape(q, num_negatives, d)               # [Q, G, D] bf16
    a = l2_normalize(a_raw)
    pos_logit = (a @ proto)[:, None]
    neg_logit = torch.bmm(negs.float(), _bf16_f32(a)[:, :, None])[:, :, 0]
    logits = torch.cat([pos_logit, neg_logit], dim=1) / temp
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


def _expected_class_loss(a_raw, proto, w, table_f32, temp: float, num_negatives: int):
    """InfoNCE of one class's anchors against G times the expected negative
    sum, ``exp(a_bf16 @ table^T / temp) @ w``, accumulated in f32."""
    a = l2_normalize(a_raw)
    pos = (a @ proto) / temp
    neg_sum = torch.exp((_bf16_f32(a) @ table_f32.T) / temp) @ w
    return torch.mean(torch.log(torch.exp(pos) + num_negatives * neg_sum) - pos)


def prototype_contrastive_loss(
    rep: torch.Tensor,           # [B, h, w, D] with gradients
    label_onehot: torch.Tensor,  # [B, h, w, C] f32 one-hot (all-zero = ignore)
    mask: torch.Tensor,          # [B, h, w] validity
    prob: torch.Tensor,          # [B, h, w, C] drives hard-anchor mining
    prototypes: torch.Tensor,    # [C, D]
    tie: torch.Tensor,           # [N] int, 24 random bits
    u1: torch.Tensor,            # [C, Q] anchor uniforms
    u: Optional[torch.Tensor] = None,        # [C, N] thinning uniforms
    tie_all: Optional[torch.Tensor] = None,  # [N] int, 24 random bits
    u_cls: Optional[torch.Tensor] = None,    # [C, Q * G]
    u_pix: Optional[torch.Tensor] = None,    # [C, Q * G]
    *,
    num_negatives: int = 512,
    temp: float = 0.5,
    strong_threshold: float = 0.97,
    alpha: float = 0.99,
    distributed: bool = False,
    negative_mode: str = "sampled_pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(loss, new_prototypes)``; Q is ``u1.shape[1]``.  An unknown
    ``negative_mode``, or one whose draws are missing, raises ValueError."""
    if negative_mode not in NEGATIVE_MODES:
        raise ValueError(f"unknown negative_mode {negative_mode} (one of {NEGATIVE_MODES})")
    given = {"u": u, "tie_all": tie_all, "u_cls": u_cls, "u_pix": u_pix}
    missing = [k for k in _NEEDS[negative_mode] if given[k] is None]
    if missing:
        raise ValueError(f"negative_mode {negative_mode} needs the draws {missing}")
    b, h, w, d = rep.shape
    num_classes = label_onehot.shape[-1]
    n = b * h * w
    g = num_negatives

    rep_flat = rep.reshape(n, d).float()
    rep_ng = rep_flat.detach()
    onehot_flat = label_onehot.reshape(n, num_classes)
    cls_id = torch.argmax(onehot_flat, dim=-1)
    member = (onehot_flat.amax(dim=-1) > 0) & (mask.reshape(n) > 0)

    new_protos, _ = update_prototypes(rep_ng, cls_id, member, prototypes, alpha, distributed)
    protos_n = l2_normalize(new_protos)

    prob_at_cls = torch.sum(onehot_flat * prob.reshape(n, num_classes).detach(), dim=-1)
    hard = member & (prob_at_cls < strong_threshold)
    order_hard, counts_hard, off_hard = grouped_random_order(cls_id, hard, tie, num_classes)

    if negative_mode == "sampled":
        # the table sorted by (class, random key), so that a class's pixels
        # are one contiguous, randomly ordered run
        order_all, counts_all, off_all = grouped_random_order(cls_id, member, tie_all,
                                                              num_classes)
        counts_all = counts_all.float()
        rep_table = l2_normalize(rep_ng)[order_all].to(torch.bfloat16)
    else:
        counts_all = _class_onehot(cls_id, member, num_classes).sum(0)
        rep_table = l2_normalize(rep_ng).to(torch.bfloat16)      # [N, D] no grad
    local_valid = counts_all > 0
    valid_num = local_valid.sum()

    # anchors: uniform with replacement from each class's hard pool
    k1 = torch.floor(u1 * torch.clamp_min(counts_hard, 1)[:, None].float()).long()
    anchors = rep_flat[order_hard[off_hard[:, None] + k1]]  # [C, Q, D] (grad)

    # negative class law: softmax(proto sim / temp) over the other valid classes
    eye = torch.eye(num_classes, dtype=torch.bool, device=rep.device)
    allowed = ~eye & local_valid[None, :]
    neg_logits = torch.where(allowed, (protos_n @ protos_n.T) / temp,
                             torch.full_like(protos_n[:, :1], -torch.inf))
    p = torch.softmax(neg_logits, dim=-1)
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    contribute = local_valid & (counts_hard > 0)

    if negative_mode == "sampled":
        cdf = torch.cumsum(p, dim=-1)
        offsets = off_all.float()

        def class_loss(c):
            return checkpoint(_sampled_class_loss, anchors[c], protos_n[c], cdf[c], u_cls[c],
                              u_pix[c], counts_all, offsets, rep_table, temp, g,
                              use_reentrant=False)
    else:
        # per-pixel weight of class c's negatives: p_c[class(n)] / count(class(n))
        masked_cls = torch.where(member, cls_id, torch.full_like(cls_id, num_classes))
        p_over_cnt = F.pad(p / torch.clamp_min(counts_all, 1.0)[None, :], (0, 1))  # [C, C+1]
        if negative_mode == "expected":
            table_f32 = rep_table.float()
        else:
            # every class's live rows at once: the weights p_over_cnt[c][masked_cls],
            # in sampled_pallas thinned from G times them with the uniforms u[c]
            idx, wv, n_live = class_live_rows(p_over_cnt, masked_cls.int(), g,
                                              u if negative_mode == "sampled_pallas" else None)

        def class_loss(c):
            if negative_mode == "expected":
                return checkpoint(_expected_class_loss, anchors[c], protos_n[c],
                                  p_over_cnt[c][masked_cls], table_f32, temp, g,
                                  use_reentrant=False)
            a = l2_normalize(anchors[c])
            pos = (a @ protos_n[c]) / temp                              # [Q]
            neg_sum = weighted_exp_softsum_live(a, rep_table, idx[c], wv[c], n_live[c:c + 1],
                                                1.0 / temp)
            if negative_mode == "expected_pallas":
                neg_sum = g * neg_sum
            return torch.mean(torch.log(torch.exp(pos) + neg_sum) - pos)

    total = rep_flat.new_zeros(())
    for c in range(num_classes):
        loss_c = class_loss(c)
        total = total + torch.where(contribute[c], loss_c, torch.zeros_like(loss_c))
    loss = torch.where(valid_num > 1, total / torch.clamp_min(valid_num, 1), torch.zeros_like(total))
    return loss, new_protos
