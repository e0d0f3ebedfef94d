"""The semi-supervised train step, strategies ``ori``, ``mix`` and ``cross``,
counterpart of ``css_tpu/train/train_step.py::make_train_step``.

Dataflow, in the reference's module-call order:

  augment the labeled batch -> base-crop the unlabeled batch -> teacher
  forward (train mode, no grad) -> pseudo-labels and confidences -> scale /
  crop, mixing, photometric + flip of the unlabeled batch -> student forward
  on labeled, then on unlabeled -> CE (or OHEM CE) + attention-threshold +
  prototype contrastive losses -> backward -> SGD (nesterov, poly LR) ->
  teacher EMA.

``fused_forward`` runs each pair of forwards (the student's labeled and
unlabeled, and the ``mix``/``cross`` teacher's) as one pass over the
concatenated batch with ``bn_groups=2``: the grouped BatchNorm keeps each
half's statistics and advances the running stats labeled first, as the two
passes do.

The strategies differ in the pseudo-labels and in the probability that
mines the contrastive anchors:

* ``ori``: the teacher sees the unlabeled batch; logit-space labels; the
  student's softmax mines the anchors;
* ``mix``: the teacher sees the labeled batch, then the unlabeled one (its
  BN running stats advance twice, in that order); a pixel keeps its
  logit-space label where the representation-space label (the nearest
  prototype by cosine) agrees, and is ignored elsewhere; the softmax of the
  student's prototype similarities mines the anchors;
* ``cross``: as ``mix``, but both label maps survive, and the unsupervised
  target switches to the representation-space labels when
  ``use_rep_labels`` is true.

``aug_quantize`` runs every augmentation hop under the reference's uint8
law (``ops/augment.py``, ``ops/photometric.py``); ``negative_mode`` picks
the contrastive loss's negatives (``losses/contrastive.py``).

Mixed precision mirrors the JAX casts explicitly (no autocast): the model
casts conv weights and activations to its ``dtype``; BatchNorm statistics,
model outputs and losses are f32.  Every random draw arrives in ``draws``
(``train/draws.py``).  The step updates ``state`` in place and returns it
with the step's losses.

A failed step can be retried.  Before its commit (``optimizer.step()``) the
step changes the state only in the BatchNorm running stats of the student
and the teacher; it copies those buffers on the device when it starts, and
a fault before the commit puts them back, so the state is again exactly what
the step was given (the counterpart of JAX's pure step).  A fault at or
after the commit leaves the state half-updated: the step marks it
``consumed`` and refuses it from then on, as a JAX step refuses donated
buffers that are already deleted.

On the card, outside ``distributed``, the step runs as replays of CUDA
graphs (``train/graph_step.py``): after a key's first (eager) call, a call
captures the step's device work once and each later call copies its inputs
into the graphs' and replays them, with no host synchronisation and a few
launches.  The per-step numbers (the learning rate, the EMA decay, the
contrastive weight) reach the device as 0-dim tensors filled in place
(``_StepScalars``), so a replay reads the step's own.  Where a capture fails
(an op that waits for the host), the step stays eager.

``distributed`` (the JAX step's ``axis_name``): the step runs on every rank
of the default process group, each on its shard of the batch with its own
draws, the model built with cross-replica BatchNorm.  Besides the BN
statistics, the prototype sums and the mixing partners (``mix_partner``),
it averages the gradients over the ranks after ``backward()`` (one
all-reduce of one flat buffer, before the SGD update) and the four losses it
returns.  Every rank issues the same collectives in the same order, and
they add no host synchronisation.

The step's phases are spans of ``utils/profiling.py``, recorded only under
``torch.profiler`` or ``tracing()``: ``css.step`` (the whole call),
``css.augment`` (the labeled transform and the unlabeled base crop; then the
unlabeled chain after the teacher), ``css.teacher``, ``css.student``,
``css.losses``, ``css.backward`` (with the gradient mean) and ``css.update``
(SGD, EMA, prototypes); on the graph path ``css.graph`` holds the replays,
between which the others open and close.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch

from css_tpu_torch.losses.contrastive import (NEGATIVE_MODES, l2_normalize,
                                              prototype_contrastive_loss)
from css_tpu_torch.losses.cross_entropy import cross_entropy, ohem_cross_entropy
from css_tpu_torch.losses.threshold import attention_threshold_loss
from css_tpu_torch.ops.augment import (batch_transform, normalize_imagenet,
                                       to_channel_first, to_channel_last)
from css_tpu_torch.ops.interpolate import bilinear_resize, nearest_resize
from css_tpu_torch.ops.mixing import MIX_MODES, PARTNERS, mix_batch
from css_tpu_torch.ops.onehot import label_onehot, label_onehot_ignore
from css_tpu_torch.ops.photometric import device_constant, exact_div
from css_tpu_torch.parallel.mesh import all_reduce_sum, mean_gradients, world_size
from css_tpu_torch.train.draws import StepDraws
from css_tpu_torch.train.graph_step import StepGraphs
from css_tpu_torch.train.schedulers import teacher_ema_decay
from css_tpu_torch.train.state import TrainState, ema_update, sgd_step
from css_tpu_torch.utils.profiling import span

__all__ = ["StepConfig", "STRATEGIES", "SUP_LOSSES", "make_train_step", "make_eval_step",
           "make_sliding_eval_step", "window_probs", "eval_mode"]

STRATEGIES = ("ori", "mix", "cross")
SUP_LOSSES = ("ce", "ohem")
LOSS_NAMES = ("total", "sup", "unsup", "contrast")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Hyper-parameters of the train step, the JAX ``StepConfig``'s fields."""

    num_classes: int
    crop_hw: Tuple[int, int]
    scale_range: Tuple[float, float]
    strategy: str = "ori"                     # ori | mix | cross
    mix_mode: str = "cutmix"                  # none | cutout | cutmix | classmix
    mix_partner: str = "reference"            # reference | ring (across ranks)
    sup_loss: str = "ce"                      # ce | ohem
    ohem_thresh: float = 0.7
    ohem_min_kept_per_image: int = 50000      # times the labeled batch
    un_threshold: float = 0.97
    weak_threshold: float = 0.7
    strong_threshold: float = 0.97
    temp: float = 0.5                         # contrastive temperature
    rep_temp: float = 0.5                     # representation-space label temperature
    num_queries: int = 256
    num_negatives: int = 512
    proto_alpha: float = 0.99
    ema_alpha: float = 0.99
    contrast_enabled: bool = True             # Loss.is_available in the YAML
    negative_mode: str = "sampled_pallas"     # one of losses/contrastive.py's NEGATIVE_MODES
    aug_quantize: bool = False                # the reference's uint8 law at every aug hop
    fused_forward: bool = False               # one pass over labeled + unlabeled
    distributed: bool = False                 # reduce over the default process group


def _remap_ignore(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """255 (and any out-of-range label) -> -1."""
    return torch.where((labels >= 0) & (labels < num_classes), labels,
                       torch.full_like(labels, -1))


def _to01_cf(images: torch.Tensor) -> torch.Tensor:
    """NHWC uint8/float canvas -> channel-first float [0, 1] (k / 255 rounded
    once, on the card too: the uint8 law truncates right after)."""
    if images.dtype == torch.uint8:
        images = exact_div(images.float(), 255.0)
    return to_channel_first(images)


def _rep_space_probs(rep: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] f32 cosine similarities of each pixel's representation
    to the prototypes (callers divide by their temperature and softmax).
    All-zero prototypes give similarity 0."""
    return torch.einsum("bhwd,cd->bhwc", l2_normalize(rep.float()),
                        l2_normalize(prototypes.float()))


def make_train_step(cfg: StepConfig):
    """Build ``step(state, batch, draws, contrast_weight, use_rep_labels=False)
    -> (state, metrics)``.

    ``batch`` keys: ``l_image`` [B, H, W, 3] float [0, 1] (or uint8),
    ``l_label`` [B, H, W] int (255 = ignore), ``l_valid_hw`` [B, 2],
    ``u_image`` [B, Hu, Wu, 3], ``u_valid_hw`` [B, 2].  ``contrast_weight``
    scales the contrastive loss (the driver's ramp; 1.0 for ``ori``);
    ``use_rep_labels`` matters for ``cross`` only.
    """
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {cfg.strategy!r} (one of {STRATEGIES})")
    if cfg.mix_mode not in MIX_MODES:
        raise ValueError(f"unknown mix mode {cfg.mix_mode!r} (one of {MIX_MODES})")
    if cfg.mix_partner not in PARTNERS:
        raise ValueError(f"unknown mix partner {cfg.mix_partner!r} (one of {PARTNERS})")
    if cfg.sup_loss not in SUP_LOSSES:
        raise ValueError(f"unknown sup_loss {cfg.sup_loss!r} (one of {SUP_LOSSES})")
    if cfg.negative_mode not in NEGATIVE_MODES:
        raise ValueError(f"unknown negative_mode {cfg.negative_mode!r} (one of {NEGATIVE_MODES})")
    ch, cw = cfg.crop_hw
    quantize = cfg.aug_quantize
    c = cfg.num_classes

    def pseudo_labels(state: TrainState, l_img: torch.Tensor, u_img: torch.Tensor):
        """The teacher's labels [B, K, H, W] and confidences [B, L, H, W] of
        the unlabeled batch at crop size."""
        state.teacher.train()
        if cfg.strategy == "ori":
            pred_u_t, rep_u_t = state.teacher(u_img)
        elif cfg.fused_forward:
            pred_t, rep_t = state.teacher(torch.cat([l_img, u_img]), bn_groups=2)
            pred_u_t, rep_u_t = pred_t[l_img.shape[0]:], rep_t[l_img.shape[0]:]
        else:
            state.teacher(l_img)      # advances the teacher's BN stats, labeled first
            pred_u_t, rep_u_t = state.teacher(u_img)
        probs = torch.softmax(bilinear_resize(pred_u_t, (ch, cw), align_corners=True), dim=-1)
        conf_cls, lab_cls = torch.max(probs, dim=-1)
        if cfg.strategy == "ori":
            return lab_cls[:, None], conf_cls[:, None]
        sim = bilinear_resize(_rep_space_probs(rep_u_t, state.prototypes), (ch, cw),
                              align_corners=True)
        conf_rep, lab_rep = torch.max(torch.softmax(sim / cfg.rep_temp, dim=-1), dim=-1)
        confs = torch.stack([conf_cls, conf_rep], dim=1)
        if cfg.strategy == "mix":
            agreed = torch.where(lab_cls == lab_rep, lab_cls, torch.full_like(lab_cls, -1))
            return agreed[:, None], confs
        return torch.stack([lab_cls, lab_rep], dim=1), confs

    def pseudo_label_phase(state: TrainState, l_img: torch.Tensor, u_img01: torch.Tensor,
                           draws: StepDraws):
        """No-grad teacher + the unlabeled augmentation chain; returns the
        normalized NHWC unlabeled batch, its labels and confidences."""
        with span("css.teacher"):
            labels, confs = pseudo_labels(state, l_img,
                                          to_channel_last(normalize_imagenet(u_img01)))
        with span("css.augment"):
            full_hw = device_constant((ch, cw), torch.int64,
                                      u_img01.device).expand(u_img01.shape[0], 2)
            img01, labels, confs = batch_transform(u_img01, labels, confs, full_hw, (ch, cw),
                                                   **draws.t_crop.as_kwargs(), quantize=quantize)
            img01, labels, confs = mix_batch(img01, labels, confs, mode=cfg.mix_mode,
                                             distributed=cfg.distributed,
                                             partner=cfg.mix_partner, **draws.mix.as_kwargs())
            img01, labels, confs = batch_transform(img01, labels, confs, full_hw, (ch, cw),
                                                   **draws.u_aug.as_kwargs(), quantize=quantize)
            return to_channel_last(normalize_imagenet(img01)), labels, confs

    rollback = _BufferRollback()
    scalars = {}

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: StepDraws,
             contrast_weight, use_rep_labels: bool = False
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.consumed:
            raise RuntimeError("train step: the state was consumed by a step that failed at or "
                               "after its update; copy a snapshot back before stepping it")
        dev = state.prototypes.device
        s = scalars.get(dev)
        if s is None:
            s = scalars[dev] = _StepScalars(dev)
        replay = None if graphs is None else graphs.prepare(state, batch, draws, s,
                                                            use_rep_labels)
        with span("css.step"):
            lr = s.write(state, cfg.ema_alpha, contrast_weight)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            if replay is not None:
                # the commit is inside the graphs: a fault in a replay is after it
                state.consumed = True
                losses = replay(batch, draws)
            else:
                rollback.save(state)
                try:
                    losses = device_step(state, batch, draws, s, use_rep_labels)
                except BaseException:
                    # before the commit: the buffers go back (a device that refuses
                    # the copy, after a sticky fault, leaves the state consumed); the
                    # fault itself propagates
                    if not state.consumed and not rollback.restore():
                        state.consumed = True
                    raise
            state.step += 1
            state.consumed = False
        return state, dict(zip(LOSS_NAMES, losses.unbind()))

    def device_step(state, batch, draws, s, use_rep_labels) -> torch.Tensor:
        """The step's device work, from the batch to the updated state: what a
        graph captures.  Returns the four losses stacked [4]."""
        model = state.model
        with torch.no_grad():
            with span("css.augment"):
                l_canvas = _to01_cf(batch["l_image"])
                bl, _, lh, lw = l_canvas.shape
                l_labels0 = _remap_ignore(batch["l_label"], c)[:, None]
                l_img01, l_labels, _ = batch_transform(
                    l_canvas, l_labels0, l_canvas.new_zeros((bl, 1, lh, lw)),
                    batch["l_valid_hw"], (ch, cw), **draws.l_aug.as_kwargs(), quantize=quantize)
                l_img = to_channel_last(normalize_imagenet(l_img01))
                l_label = l_labels[:, 0]

                u_canvas = _to01_cf(batch["u_image"])
                bu, _, uh, uw = u_canvas.shape
                u_img01, _, _ = batch_transform(
                    u_canvas,
                    torch.zeros((bu, 1, uh, uw), dtype=torch.long, device=u_canvas.device),
                    u_canvas.new_zeros((bu, 1, uh, uw)), batch["u_valid_hw"], (ch, cw),
                    **draws.u_crop.as_kwargs(), quantize=quantize)
            u_img, u_labels, u_confs = pseudo_label_phase(state, l_img, u_img01, draws)
        # cross switches the unsupervised target to the representation space;
        # the contrastive labels and the weak mask stay logit-space
        k = 1 if cfg.strategy == "cross" and use_rep_labels else 0
        unsup_label, unsup_conf = u_labels[:, k], u_confs[:, k]
        conf_cls = u_confs[:, 0]

        # per-half BN statistics, labeled first: two passes, or one grouped
        with span("css.student"):
            model.train()
            if cfg.fused_forward:
                pred, rep = model(torch.cat([l_img, u_img]), bn_groups=2)
                pred_l, pred_u, rep_l, rep_u = pred[:bl], pred[bl:], rep[:bl], rep[bl:]
            else:
                pred_l, rep_l = model(l_img)
                pred_u, rep_u = model(u_img)
        with span("css.losses"):
            pred_l_large = bilinear_resize(pred_l, (ch, cw), align_corners=True)
            pred_u_large = bilinear_resize(pred_u, (ch, cw), align_corners=True)
            if cfg.sup_loss == "ohem":
                sup = ohem_cross_entropy(pred_l_large, l_label, cfg.ohem_thresh,
                                         cfg.ohem_min_kept_per_image * bl)
            else:
                sup = cross_entropy(pred_l_large, l_label)
            unsup = attention_threshold_loss(pred_u_large, unsup_label, unsup_conf,
                                             cfg.un_threshold)

            if cfg.contrast_enabled:
                # the model's output size (193 at 769, 129 at 512 under the deep stem)
                hw = (pred_l.shape[1], pred_l.shape[2])
                rows = (bl + bu) * hw[0] * hw[1]
                if draws.contrast.tie.shape[0] != rows:
                    raise ValueError(f"contrastive draws sized for {draws.contrast.tie.shape[0]} "
                                     f"rows; the model's {bl}+{bu} outputs at {hw} have {rows}")
                mask_l = nearest_resize((l_label >= 0).float(), hw)
                mask_u = nearest_resize((conf_cls >= cfg.weak_threshold).float(), hw)
                onehot_u = label_onehot_ignore if cfg.strategy == "mix" else label_onehot
                label_all = torch.cat([label_onehot(nearest_resize(l_label, hw), c),
                                       onehot_u(nearest_resize(u_labels[:, 0], hw), c)])
                rep_all = torch.cat([rep_l, rep_u])
                if cfg.strategy == "ori":
                    prob_all = torch.softmax(torch.cat([pred_l, pred_u]).detach(), dim=-1)
                else:   # the prototypes before this step's update
                    prob_all = torch.softmax(
                        _rep_space_probs(rep_all.detach(), state.prototypes) / cfg.rep_temp,
                        dim=-1)
                contrast, new_protos = prototype_contrastive_loss(
                    rep_all, label_all, torch.cat([mask_l, mask_u]), prob_all, state.prototypes,
                    **draws.contrast.as_kwargs(), num_negatives=cfg.num_negatives, temp=cfg.temp,
                    strong_threshold=cfg.strong_threshold, alpha=cfg.proto_alpha,
                    distributed=cfg.distributed, negative_mode=cfg.negative_mode)
            else:
                contrast, new_protos = sup.new_zeros(()), state.prototypes
            total = sup + unsup + contrast * s.weight

        with span("css.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            if cfg.distributed:
                mean_gradients(model.parameters())
        with span("css.update"):
            # the commit: from here on a fault leaves a half-updated state
            state.consumed = True
            sgd_step(state.optimizer, s.lr)
            ema_update(state.teacher, model, s.decay, s.rest)
            if new_protos is not state.prototypes:
                state.prototypes.copy_(new_protos.detach())
        losses = torch.stack([total, sup, unsup, contrast]).detach()
        if cfg.distributed:
            losses = all_reduce_sum(losses) / world_size()
        return losses

    graphs = None if cfg.distributed else StepGraphs(device_step)
    step.graphs = graphs
    return step


class _StepScalars:
    """The step's per-step numbers as 0-dim f32 tensors on the state's device:
    the learning rate, the teacher's EMA decay, 1 - decay and the
    contrastive weight.  ``write`` fills them in place (a fill kernel each,
    the value in its arguments: no host buffer to outlive), in stream order
    before the step that reads them."""

    def __init__(self, device: torch.device):
        self.lr, self.decay, self.rest, self.weight = torch.zeros(
            4, dtype=torch.float32, device=device).unbind()

    def write(self, state: TrainState, ema_alpha: float, contrast_weight) -> float:
        """Writes the numbers of ``state``'s next step; returns its learning
        rate."""
        lr = state.lr_schedule(state.step)
        decay = teacher_ema_decay(state.step, ema_alpha)
        self.lr.fill_(lr)
        self.decay.fill_(decay)
        self.rest.fill_(1.0 - decay)      # the f32 rounding of SGD's alpha=1 - decay
        if isinstance(contrast_weight, torch.Tensor):
            self.weight.copy_(contrast_weight)
        else:
            self.weight.fill_(float(contrast_weight))
        return lr


class _BufferRollback:
    """Device copies of the student's and the teacher's buffers (the
    BatchNorm running stats), the only part of the state that a step changes
    before its commit: a few ``_foreach_copy_`` launches each way, into
    copies allocated once per state."""

    def __init__(self):
        self.live, self.saved = [], []

    def save(self, state: TrainState) -> None:
        live = list(state.model.buffers()) + list(state.teacher.buffers())
        if len(live) != len(self.live) or any(a is not b for a, b in zip(live, self.live)):
            self.live, self.saved = live, [torch.empty_like(b) for b in live]
        torch._foreach_copy_(self.saved, self.live)

    def restore(self) -> bool:
        """Puts the buffers back; False where the device refuses the copy
        (a sticky CUDA error poisons every later launch)."""
        try:
            torch._foreach_copy_(self.live, self.saved)
        except RuntimeError:
            return False
        return True


def _round_to_multiple(x: float, mult: int = 8) -> int:
    """Nearest positive multiple of ``mult``: the TTA-scaled input sizes of
    the reference."""
    return max(mult, int(round(x / mult)) * mult)


def _conf_matrix_delta(yhat: torch.Tensor, label: torch.Tensor, valid: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """[C, C] int64 confusion-matrix update (rows = target, columns =
    prediction): one bincount of length C^2 + 1 whose last bin, where padded
    rows (``valid`` False) and labels outside [0, C) land, is dropped."""
    c = num_classes
    ok = (label >= 0) & (label < c) & valid[:, None, None]
    idx = torch.where(ok, label.long() * c + yhat.long(), c * c)
    return torch.bincount(idx.reshape(-1), minlength=c * c + 1)[:-1].reshape(c, c)


@contextlib.contextmanager
def eval_mode(model):
    """``model`` in eval mode inside the block, its mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def make_eval_step(model, num_classes: int, flip: bool = False, scales=(1.0,)):
    """Build ``eval_step(conf_mat, image, label, valid) -> conf_mat``, the
    confusion-matrix accumulation over ``model`` (the EMA teacher) in eval
    mode, without gradients, in the model's compute dtype.

    ``image`` [B, H, W, 3] normalized NHWC, ``label`` [B, H, W] (-1 or any
    value outside [0, C) counts nothing), ``valid`` [B] bool (padded rows
    count nothing).  The logits are upsampled to the label size with
    ``bilinear_resize(align_corners=True)``.  ``flip``/``scales`` add
    test-time augmentation: softmax probabilities averaged over a horizontal
    flip and/or input rescales (rounded to multiples of 8) before the argmax;
    without them the step takes the argmax of the upsampled logits.
    """
    scales = tuple(float(s) for s in scales)
    plain = (not flip) and scales == (1.0,)

    def _logits(image, out_hw):
        pred, _ = model(image)
        return bilinear_resize(pred, out_hw, align_corners=True)

    @torch.no_grad()
    def eval_step(conf_mat, image, label, valid):
        with eval_mode(model):
            out_hw = label.shape[1:3]
            if plain:
                yhat = torch.argmax(_logits(image, out_hw), dim=-1)
            else:
                h, w = int(image.shape[1]), int(image.shape[2])
                prob = 0
                for s in scales:
                    im = image if s == 1.0 else bilinear_resize(
                        image, (_round_to_multiple(h * s), _round_to_multiple(w * s)),
                        align_corners=True)
                    prob = prob + torch.softmax(_logits(im, out_hw).float(), dim=-1)
                    if flip:
                        flipped = _logits(im.flip(2), out_hw).float()
                        prob = prob + torch.softmax(flipped, dim=-1).flip(2)
                yhat = torch.argmax(prob, dim=-1)
        return conf_mat + _conf_matrix_delta(yhat, label, valid, num_classes)

    return eval_step


def _tile_origins(full: int, crop: int, stride: int):
    """Window origins covering [0, full) every ``stride``, the last window
    clamped to end at ``full``."""
    if full <= crop:
        return [0]
    xs = list(range(0, full - crop + 1, stride))
    if xs[-1] != full - crop:
        xs.append(full - crop)
    return xs


def window_probs(model, image: torch.Tensor, crop_hw, stride_hw, num_classes: int):
    """[B, H, W, C] f32 coverage-averaged softmax of ``model`` over windows of
    ``crop_hw`` sliding by ``stride_hw`` across the NHWC ``image`` (zero-padded
    up to the crop when smaller): each window's logits are upsampled to the
    window with ``bilinear_resize(align_corners=True)`` and its softmax is
    added to a canvas map beside a coverage count."""
    ch, cw = crop_hw
    b, h, w = image.shape[0], int(image.shape[1]), int(image.shape[2])
    ph, pw = max(h, ch), max(w, cw)
    if (ph, pw) != (h, w):
        image = torch.nn.functional.pad(image, (0, 0, 0, pw - w, 0, ph - h))
    acc = torch.zeros((b, ph, pw, num_classes), dtype=torch.float32, device=image.device)
    cnt = torch.zeros((ph, pw, 1), dtype=torch.float32, device=image.device)
    for oy in _tile_origins(ph, ch, stride_hw[0]):
        for ox in _tile_origins(pw, cw, stride_hw[1]):
            pred, _ = model(image[:, oy:oy + ch, ox:ox + cw])
            logits = bilinear_resize(pred, (ch, cw), align_corners=True)
            acc[:, oy:oy + ch, ox:ox + cw] += torch.softmax(logits.float(), dim=-1)
            cnt[oy:oy + ch, ox:ox + cw] += 1.0
    return (acc / torch.clamp_min(cnt, 1.0))[:, :h, :w]


def make_sliding_eval_step(model, num_classes: int, canvas_hw, crop_hw, stride_hw=None,
                           flip: bool = False, scales=(1.0,)):
    """Build ``eval_step(conf_mat, image, label, valid) -> conf_mat`` (the
    signature of :func:`make_eval_step`'s) over the whole canvas with
    overlapping crop-sized windows: the benchmark protocol, in place of the
    reference's one random crop.

    Per canvas variant (each scale of ``scales``, rounded to multiples of 8,
    and its mirror image when ``flip``): :func:`window_probs` over the
    static origin table (``_tile_origins`` per axis, stride ``stride_hw``, by
    default 2/3 of the crop), mirrored back and resized to the canvas.  The
    argmax of the variants' sum feeds the confusion matrix.
    """
    ch, cw = crop_hw
    fh, fw = canvas_hw
    sh, sw = stride_hw or (2 * ch // 3, 2 * cw // 3)
    scales = tuple(float(s) for s in scales)

    @torch.no_grad()
    def eval_step(conf_mat, image, label, valid):
        with eval_mode(model):
            total = 0
            for s in scales:
                im = image if s == 1.0 else bilinear_resize(
                    image, (_round_to_multiple(fh * s), _round_to_multiple(fw * s)),
                    align_corners=True)
                variants = [(im, False)] + ([(im.flip(2), True)] if flip else [])
                for v, mirrored in variants:
                    p = window_probs(model, v, crop_hw, (sh, sw), num_classes)
                    if mirrored:
                        p = p.flip(2)
                    if s != 1.0:
                        p = bilinear_resize(p, (fh, fw), align_corners=True)
                    total = total + p
            yhat = torch.argmax(total, dim=-1)
        return conf_mat + _conf_matrix_delta(yhat, label, valid, num_classes)

    return eval_step
