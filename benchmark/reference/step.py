"""Plain float32 training step of the recipe, strategy ``ori``.

The reference's step (CSS, arXiv:2307.09755): the labeled batch scaled,
cropped, jittered, blurred and flipped; the unlabeled batch cropped; the EMA
teacher (train mode, no gradient) labels it; the labels and confidences
ride through a scaled crop, CutMix and the photometric chain; the student
runs on the labeled, then on the unlabeled batch (or on both at once with
per-half BatchNorm statistics); CE (or OHEM CE), the attention-threshold
loss and the prototype contrastive loss with thinned negative
multiplicities; SGD with nesterov momentum, coupled weight decay and the
poly learning rate; the teacher's EMA; the prototypes' EMA.

Everything is float32 and plain PyTorch (TF32 is switched off by the caller);
the contrastive negatives are summed over the live rows of each class as a
plain product.  Imports nothing of the program under test.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import augment as A

__all__ = ["StepSettings", "RefState", "train_step", "poly_lr", "ema_decay"]


class StepSettings:
    """The step's hyper-parameters, read from a benchmark configuration."""

    def __init__(self, config: dict, total_steps: int):
        net, loss, data = config["Network"], config["Loss"], config["Dataset"]
        self.num_classes = net["num_class"]
        self.crop = tuple(data["crop_size"])
        self.scale = tuple(data["scale_size"])
        self.sup_loss = loss["sup_loss"]
        self.ohem_thresh = loss.get("ohem_thresh", 0.7)
        self.ohem_min_kept = loss.get("ohem_min_kept_per_image", 50000)
        self.un_threshold = loss["un_threshold"]
        self.weak_threshold = loss["weak_threshold"]
        self.strong_threshold = loss["strong_threshold"]
        self.temp = loss["temp"]
        self.num_queries = loss["num_queries"]
        self.num_negatives = loss["num_negatives"]
        self.proto_alpha = loss["alpha"]
        self.ema_alpha = config["EMA"]["alpha"]
        self.fused = bool(config.get("Training_Setting", {}).get("fused_forward", False))
        self.lr = float(config["Optim"]["lr"])
        self.weight_decay = float(config["Optim"]["weight_decay"])
        self.power = float(config["Lr_Scheduler"]["power"])
        self.min_lr = float(config["Lr_Scheduler"]["min_lr"])
        self.total_steps = total_steps
        if loss.get("negative_mode", "sampled_pallas") != "sampled_pallas":
            raise ValueError("reference: negative_mode sampled_pallas only")
        if data.get("mix_mode", "cutmix") != "cutmix":
            raise ValueError("reference: mix_mode cutmix only")


def poly_lr(step: int, s: StepSettings) -> float:
    f32 = np.float32
    frac = f32(1.0) - f32(step) / f32(s.total_steps)
    return float(np.maximum(f32(s.lr) * np.maximum(frac, f32(0.0)) ** f32(s.power),
                            f32(s.min_lr)))


def ema_decay(step: int, alpha: float) -> float:
    f32 = np.float32
    return float(np.minimum(f32(1.0) - f32(1.0) / (f32(step) + f32(1.0)), f32(alpha)))


class RefState:
    """Student, teacher (a copy of the student at the start), SGD momentum
    buffers, prototypes and the step counter; ``first_grads`` keeps the
    gradients of the first step."""

    def __init__(self, student, num_classes: int, output_dim: int):
        self.student = student
        self.teacher = copy.deepcopy(student).requires_grad_(False)
        dev = next(student.parameters()).device
        self.prototypes = torch.zeros(num_classes, output_dim, device=dev)
        self.momentum = {}
        self.step = 0
        self.first_grads: Optional[dict] = None
        self.last_terms: dict = {}


# ------------------------------------------------------------------ losses --

def nll(logits, labels):
    """Per-pixel CE of NHWC logits; 0 where the label is negative."""
    logp = F.log_softmax(logits, dim=-1)
    out = -torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(labels >= 0, out, torch.zeros_like(out))


def cross_entropy(logits, labels):
    return nll(logits, labels).sum() / (labels >= 0).float().sum().clamp_min(1.0)


def ohem(logits, labels, thresh, min_kept):
    """The reference's ProbOhemCrossEntropy2d: CE over the valid pixels whose
    target probability is at most max(k-th smallest, thresh)."""
    labels = labels.long()
    valid = labels >= 0
    prob = torch.softmax(logits, dim=-1)
    target = torch.gather(prob, -1, labels.clamp_min(0)[..., None])[..., 0].detach()
    flat = torch.where(valid, target, torch.ones_like(target)).reshape(-1)
    kth = torch.kthvalue(flat, min(int(min_kept), flat.numel())).values
    keep = torch.where(valid.sum() < min_kept, torch.full_like(kth, float("inf")),
                       torch.clamp_min(kth, thresh))
    kept = valid & (target <= keep)
    return nll(logits, torch.where(kept, labels, torch.full_like(labels, -1))).sum() \
        / kept.sum().clamp_min(1)


def threshold_loss(logits, labels, conf, threshold):
    """Attention-threshold CE: each image weighted by its share of confident
    pseudo-labels, averaged over the positive entries."""
    b = logits.shape[0]
    valid = (labels >= 0).reshape(b, -1).float()
    confident = (conf >= threshold).reshape(b, -1).float()
    denom = valid.sum(-1)
    weight = torch.where(denom > 0, confident.sum(-1) / denom.clamp_min(1.0),
                         torch.zeros_like(denom))
    loss = nll(logits, labels)
    pos = (loss > 0).float()
    total = (weight[:, None, None] * loss * pos).sum() / pos.sum().clamp_min(1.0)
    return torch.where(pos.sum() > 0, total, torch.zeros_like(total))


def l2n(x, eps=1e-12):
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def contrastive(rep, onehot, mask, prob, protos, tie, u1, u, s: StepSettings):
    """Prototype contrastive loss: per class, Q hard anchors drawn through a
    random per-class order, the own (updated) prototype as the positive, and
    as negatives every member pixel n of the other classes, with the thinned
    multiplicity floor(lam) + (u < lam - floor(lam)), lam = G p(class(n)) /
    count(class(n)), p the softmax of the prototypes' similarities / temp.
    Returns (loss, new prototypes)."""
    b, h, w, d = rep.shape
    c = onehot.shape[-1]
    n = b * h * w
    flat = rep.reshape(n, d)
    oh = onehot.reshape(n, c)
    cls = torch.argmax(oh, dim=-1)
    member = (oh.amax(-1) > 0) & (mask.reshape(n) > 0)
    masked = torch.where(member, cls, torch.full_like(cls, c))
    members = F.one_hot(masked, c + 1)[:, :c].float()
    counts = members.sum(0)
    mean = (members.T @ flat.detach()) / counts.clamp_min(1.0)[:, None]
    never = protos.sum(1, keepdim=True) == 0
    ema = torch.where(never, mean, s.proto_alpha * protos + (1 - s.proto_alpha) * mean)
    new_protos = torch.where(counts[:, None] > 0, ema, protos)
    pn = l2n(new_protos)

    hard = member & ((oh * prob.reshape(n, c)).sum(-1) < s.strong_threshold)
    key = torch.where(hard, cls, torch.full_like(cls, c)).int()
    order = torch.sort((key << 24) | tie.int(), stable=True).indices
    counts_h = torch.bincount(key.long(), minlength=c + 1)[:c]
    off_h = torch.cumsum(counts_h, 0) - counts_h
    pick = torch.floor(u1 * counts_h.clamp_min(1)[:, None].float()).long()
    anchors = flat[order[off_h[:, None] + pick]]                       # [C, Q, D]

    valid = counts > 0
    allowed = ~torch.eye(c, dtype=torch.bool, device=rep.device) & valid[None, :]
    logits = torch.where(allowed, (pn @ pn.T) / s.temp, torch.full_like(pn[:, :1], -torch.inf))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    p_over_cnt = F.pad(p / counts.clamp_min(1.0)[None, :], (0, 1))
    table = l2n(flat.detach())
    total = flat.new_zeros(())
    for k in range(c):
        if not (valid[k] and counts_h[k] > 0):
            continue
        lam = s.num_negatives * p_over_cnt[k][masked]
        mult = torch.floor(lam) + (u[k] < lam - torch.floor(lam)).float()
        live = torch.nonzero(mult).squeeze(1)
        a = l2n(anchors[k])
        pos = (a @ pn[k]) / s.temp
        neg = (torch.exp((a @ table[live].T) / s.temp) * mult[live][None, :]).sum(1)
        total = total + torch.mean(torch.log(torch.exp(pos) + neg) - pos)
    nvalid = valid.sum()
    loss = total / nvalid.clamp_min(1) if nvalid > 1 else torch.zeros_like(total)
    return loss, new_protos


# -------------------------------------------------------------------- step --

def _onehot(labels, c):
    return F.one_hot(labels.clamp_min(0).long(), c).float()


def train_step(st: RefState, batch: dict, d: dict, s: StepSettings):
    """One step on ``st`` in place; returns the total loss as a float (the
    supervised and contrastive terms in ``st.last_terms``)."""
    c = s.num_classes
    ch, cw = s.crop
    with torch.no_grad():
        l_canvas = A.nchw(batch["l_image"].float() / 255.0)
        bl, _, lh, lw = l_canvas.shape
        lab = batch["l_label"].long()
        lab = torch.where((lab >= 0) & (lab < c), lab, torch.full_like(lab, -1))[:, None]
        l01, l_lab, _ = A.transform(l_canvas, lab, l_canvas.new_zeros((bl, 1, lh, lw)),
                                    batch["l_valid_hw"], s.crop, d["l_aug"])
        l_img, l_label = A.nhwc(A.normalize(l01)), l_lab[:, 0]

        u_canvas = A.nchw(batch["u_image"].float() / 255.0)
        bu, _, uh, uw = u_canvas.shape
        u01, _, _ = A.transform(u_canvas, torch.zeros((bu, 1, uh, uw), dtype=torch.long,
                                                      device=u_canvas.device),
                                u_canvas.new_zeros((bu, 1, uh, uw)), batch["u_valid_hw"],
                                s.crop, d["u_crop"])
        st.teacher.train()
        pred_t, _ = st.teacher(A.nhwc(A.normalize(u01)))
        conf, plab = torch.max(torch.softmax(A.bilinear(pred_t, (ch, cw)), dim=-1), dim=-1)
        full = torch.tensor([ch, cw], device=u01.device).expand(bu, 2)
        img, labs, confs = A.transform(u01, plab[:, None], conf[:, None], full, s.crop,
                                       d["t_crop"])
        img, labs, confs = A.cutmix(img, labs, confs, **d["mix"])
        img, labs, confs = A.transform(img, labs, confs, full, s.crop, d["u_aug"])
        u_img, u_label, u_conf = A.nhwc(A.normalize(img)), labs[:, 0], confs[:, 0]

    model = st.student
    model.train()
    if s.fused:
        pred, rep = model(torch.cat([l_img, u_img]), bn_groups=2)
        pred_l, pred_u, rep_l, rep_u = pred[:bl], pred[bl:], rep[:bl], rep[bl:]
    else:
        pred_l, rep_l = model(l_img)
        pred_u, rep_u = model(u_img)
    big_l, big_u = A.bilinear(pred_l, (ch, cw)), A.bilinear(pred_u, (ch, cw))
    if s.sup_loss == "ohem":
        sup = ohem(big_l, l_label, s.ohem_thresh, s.ohem_min_kept * bl)
    else:
        sup = cross_entropy(big_l, l_label)
    unsup = threshold_loss(big_u, u_label, u_conf, s.un_threshold)

    hw = tuple(pred_l.shape[1:3])
    mask = torch.cat([A.nearest((l_label >= 0).float(), hw),
                      A.nearest((u_conf >= s.weak_threshold).float(), hw)])
    onehot = torch.cat([_onehot(A.nearest(l_label, hw), c), _onehot(A.nearest(u_label, hw), c)])
    prob = torch.softmax(torch.cat([pred_l, pred_u]).detach(), dim=-1)
    con, new_protos = contrastive(torch.cat([rep_l, rep_u]), onehot, mask, prob, st.prototypes,
                                  **d["contrast"], s=s)
    total = sup + unsup + con
    st.last_terms = {"sup": float(sup.detach()), "contrast": float(con.detach())}

    for p in model.parameters():
        p.grad = None
    total.backward()
    params = dict(model.named_parameters())
    if st.first_grads is None:
        st.first_grads = {k: p.grad.detach().clone() for k, p in params.items()}
    lr = poly_lr(st.step, s)
    with torch.no_grad():
        for k, p in params.items():
            dp = p.grad + s.weight_decay * p
            buf = st.momentum.get(k)
            buf = dp.clone() if buf is None else buf.mul_(0.9).add_(dp)
            st.momentum[k] = buf
            p.sub_(lr * (dp + 0.9 * buf))
        decay = ema_decay(st.step, s.ema_alpha)
        for tp, sp in zip(st.teacher.parameters(), model.parameters()):
            tp.mul_(decay).add_(sp, alpha=1.0 - decay)
    st.prototypes = new_protos.detach()
    st.step += 1
    return float(total.detach())
