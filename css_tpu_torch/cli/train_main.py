"""Training driver behind the port's entry points (strategies ``ori``,
``mix`` and ``cross``), counterpart of ``css_tpu/cli/train_main.py``.

Each epoch pairs every labeled batch with the next batch of an endless
unlabeled stream.  Host threads decode the batches into numpy canvases
(``data/loader.py``; with the host decoder where it could be built, else
PIL, as the log's ``decoder:`` line says); the canvases are copied to the
device from pinned memory on a side stream, one batch ahead of the step
that consumes them.
After an epoch the EMA teacher is evaluated on the validation split,
``best_model`` is saved when the mIoU is at least the best so far, and the
rolling ``last_model`` is stamped with the best mIoU.  The step's losses stay
on the device until eval time, so the steps between evals run without a host
synchronisation.

What the strategies do differently, as the JAX driver does:

* ``ori`` evaluates every epoch, reads its thresholds from the YAML (a flag
  given overrides it; ``--temp`` sets ``Loss.temp``) and weights the
  contrastive loss by 1;
* ``mix`` and ``cross`` take their thresholds from the flags, with the
  reference scripts' defaults (strong 0.8, weak 0.7, unsupervised 0.97;
  ``--temp``, default 0.5, is the representation-space label temperature
  ``Loss.rep_temp``), weight the contrastive loss by the per-epoch
  ``Ramp_Scheduler`` ramp-down (``--sche``, on by default; 1 when off), and
  evaluate only every 20th epoch, in the last 50 epochs, at the last epoch
  and when the run ends (a time-only log line otherwise);
* ``cross`` supervises with the representation-space labels from epoch
  ``--warmup`` on, and ``--prototypes_resume`` seeds its prototypes from
  another run's checkpoint.

Random draws are functions of counters, not of a run's history: step ``s``
on rank ``r`` draws from a generator seeded by ``(Seed + 1, s, r)``, so a
resumed run draws for step ``s`` what an uninterrupted run at its world size
draws; eval ``e`` (the epoch) crops batch ``b`` with a generator seeded by
``(Seed, e, b)``.

Data parallelism, as the JAX driver's mesh over ``--num_devices`` devices:
one process per device.  ``--num_devices N`` > 1 spawns N processes (rank r
on ``cuda:r`` over NCCL, or on the CPU over gloo with ``--device cpu``);
under ``torchrun`` each process joins the group its environment describes.
``Dataset.batch_size`` is the per-device batch: each rank's loaders take
their shard of every split (the synthetic splits are sized from the global
batch), the model's BatchNorms take cross-replica statistics, and the step
averages the gradients and losses over the ranks (``train/train_step.py``).
Rank 0's state is broadcast once after the build and the resume; a
checkpoint written at one world size resumes at any other.  Each rank
evaluates its shard of the validation split, and the confusion matrix is
summed over the ranks once.  Only rank 0 writes ``config.yaml``,
``train.log``, the TensorBoard scalars and the checkpoints.  SIGTERM is
polled across the ranks every ``Training_Setting.preempt_check_every``
steps (default 10), so all ranks leave at the same step.  A run over more
than one rank ends by checking that every rank holds the same state (a
SHA-256 of it per rank, in the result).

Fault recovery, as the JAX driver's: the runtime's faults (the allocator's
``OutOfMemoryError``, a CUDA error, a cuDNN or cuBLAS status; never any
other exception) are caught around the step and the eval, and each catch is
logged.  A step that failed before its commit left the state as it was
given (``train/train_step.py``) and runs again in place; if that fails too,
or the fault struck at or after the commit, a host snapshot of the state is
copied back and the batch runs again from it; a third failure propagates.
The snapshot is taken before the first step and refreshed at eval points
every ``Training_Setting.host_recovery`` epochs (default 1; 0: none).  An
eval that faults is skipped: mIoU -1, the best mIoU and ``best_model`` left
alone.  Over more than one rank a fault propagates and ends every rank (a
rank that ran its step again would reissue collectives its peers already
matched); the run continues with ``--resume`` from ``last_model``.

The recipe's network and loss settings come from the YAML as the JAX
driver reads them: ``Network.backbone`` (``resnet101``, ``resnet101_stem``,
``tiny``, ``tiny_stem``; SegFormer's ``mit_b5``, ``mit_tiny``), ``Network.remat``
(a bool or a list of stage indices; for a ResNet trunk by default on when the
crop area exceeds 512², for a MiT trunk off, and it refuses it) and
``Network.remat_policy``, ``Loss.sup_loss`` (``ohem`` by default for 19
classes, else ``ce``) with ``Loss.ohem_thresh`` and
``Loss.ohem_min_kept_per_image``, ``Loss.negative_mode`` (``sampled_pallas``
by default; ``sampled``, ``expected``, ``expected_pallas``),
``Training_Setting.fused_forward`` and ``Training_Setting.aug_quantize``
(the reference's uint8 augmentation law).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from css_tpu_torch import parallel, resolve_device
from css_tpu_torch.config import CONFIG_DIR, dump_config, load_config
from css_tpu_torch.data import (BatchLoader, InfiniteLoader, build_dataset_specs, decoder_line,
                                read_split_lists)
from css_tpu_torch.models.convert import load_torchvision_backbone
from css_tpu_torch.models.deeplabv3 import RESNET_BACKBONES, build_model
from css_tpu_torch.ops.augment import (batch_transform, normalize_imagenet, to_channel_first,
                                       to_channel_last)
from css_tpu_torch.train.checkpoint import (load_prototypes, restore_checkpoint, save_checkpoint,
                                            state_sha256)
from css_tpu_torch.train.draws import sample_augment_draws, sample_step_draws
from css_tpu_torch.train.schedulers import rampdown_value
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import (STRATEGIES, StepConfig, make_eval_step,
                                            make_train_step)
from css_tpu_torch.utils import ConfusionMatrix, Logger, ScalarWriter
from css_tpu_torch.utils.preempt import PreemptionGuard
from css_tpu_torch.utils.profiling import StepTimer, maybe_profile, per_step_line, reset, snapshot

__all__ = ["run_training", "train_on", "add_common_args"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_common_args(parser, default_job: str):
    parser.add_argument("--config", type=str,
                        default=os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"))
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--num_labels", type=int, default=92)
    parser.add_argument("--total_iter", type=int, default=80000)
    parser.add_argument("--job_name", type=str, default=default_job)
    # hyper-parameter shadows of the YAML
    parser.add_argument("--strong_threshold", type=float, default=None)
    parser.add_argument("--weak_threshold", type=float, default=None)
    parser.add_argument("--un_threshold", type=float, default=None)
    parser.add_argument("--temp", type=float, default=None)
    parser.add_argument("--sche", type=lambda s: s.lower() != "false", default=True)
    # runtime
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--txt_dir", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (no dataset required)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices to train on, one process each (default 1)")
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="hard cap on optimizer steps (debug/smoke)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    return parser


def _apply_cli_shadows(cfg, args, strategy: str) -> None:
    """``ori`` reads its thresholds from the YAML and flags given override
    them; ``mix`` and ``cross`` take them from the flags, with the reference
    scripts' defaults, and ``--temp`` is their ``Loss.rep_temp``."""
    if strategy in ("mix", "cross"):
        for flag, key, default in [(args.strong_threshold, "Loss.strong_threshold", 0.8),
                                   (args.weak_threshold, "Loss.weak_threshold", 0.7),
                                   (args.un_threshold, "Loss.un_threshold", 0.97),
                                   (args.temp, "Loss.rep_temp", 0.5)]:
            cfg.set(key, default if flag is None else flag)
    else:
        for flag, key in [(args.strong_threshold, "Loss.strong_threshold"),
                          (args.weak_threshold, "Loss.weak_threshold"),
                          (args.un_threshold, "Loss.un_threshold"),
                          (args.temp, "Loss.temp")]:
            if flag is not None:
                cfg.set(key, flag)
    if args.data_dir:
        cfg.set("Dataset.data_dir", args.data_dir)
    if args.txt_dir:
        cfg.set("Dataset.txt_dir", args.txt_dir)
    if args.synthetic:
        cfg.set("Dataset.name", "Synthetic")


def _remat_setting(value):
    """``Network.remat`` as the trunk takes it: a list of stage indices as a
    tuple, one index as a 1-tuple (not ``bool(int)``, which would remat
    every stage), anything else as a bool."""
    if isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(value, int) and not isinstance(value, bool):
        return (value,)
    return bool(value)


def _step_config(cfg, strategy: str, distributed: bool) -> StepConfig:
    """The train step's settings as the YAML (after the flags) says."""
    num_classes = cfg.require("Network.num_class")
    return StepConfig(
        num_classes=num_classes,
        crop_hw=tuple(cfg.require("Dataset.crop_size")),
        scale_range=tuple(cfg.require("Dataset.scale_size")),
        strategy=strategy,
        mix_mode=cfg.get("Dataset.mix_mode", "cutmix"),
        mix_partner=cfg.get("Distributed.mix_partner", "reference"),
        # by the class count (19: the Cityscapes taxonomy), not Dataset.name,
        # which --synthetic rewrites
        sup_loss=cfg.get("Loss.sup_loss", "ohem" if num_classes == 19 else "ce"),
        ohem_thresh=cfg.get("Loss.ohem_thresh", 0.7),
        ohem_min_kept_per_image=cfg.get("Loss.ohem_min_kept_per_image", 50000),
        un_threshold=cfg.get("Loss.un_threshold", 0.97),
        weak_threshold=cfg.get("Loss.weak_threshold", 0.7),
        strong_threshold=cfg.get("Loss.strong_threshold", 0.97),
        temp=cfg.get("Loss.temp", 0.5),
        rep_temp=cfg.get("Loss.rep_temp", cfg.get("Loss.temp", 0.5)),
        num_queries=cfg.get("Loss.num_queries", 256),
        num_negatives=cfg.get("Loss.num_negatives", 512),
        proto_alpha=cfg.get("Loss.alpha", 0.99),
        ema_alpha=cfg.get("EMA.alpha", 0.99),
        contrast_enabled=bool(cfg.get("Loss.is_available", True)),
        negative_mode=cfg.get("Loss.negative_mode", "sampled_pallas"),
        aug_quantize=bool(cfg.get("Training_Setting.aug_quantize", False)),
        fused_forward=bool(cfg.get("Training_Setting.fused_forward", False)),
        distributed=distributed,
    )


def _build_state_and_steps(cfg, args, device, strategy: str = "ori", distributed: bool = False):
    """The train state on ``device``, the step config, the train step and
    the eval step, as the YAML and the flags say; ``distributed``: the model
    and the step reduce over the default process group."""
    num_classes = cfg.require("Network.num_class")
    output_dim = cfg.get("Network.output_dim", 256)
    crop = tuple(cfg.require("Dataset.crop_size"))
    backbone = cfg.get("Network.backbone", "resnet101")
    resnet = backbone in RESNET_BACKBONES
    model = build_model(num_classes, output_dim, backbone,
                        dtype=_DTYPES[cfg.get("Network.dtype", "bfloat16")],
                        seed=cfg.get("Seed", 3407),
                        # a ResNet trunk's by crop area, the quantity that sets activation
                        # memory; a MiT trunk has no remat
                        remat=_remat_setting(cfg.get("Network.remat",
                                                     resnet and crop[0] * crop[1] > 512 * 512)),
                        remat_policy=cfg.get("Network.remat_policy", "nothing"),
                        distributed=distributed)
    pretrained = cfg.get("Network.pretrained", "./pretrained/resnet101.pth")
    if resnet and pretrained and os.path.exists(pretrained):
        sd = torch.load(pretrained, map_location="cpu", weights_only=True)
        load_torchvision_backbone(sd.get("state_dict", sd), model)
    state = create_train_state(
        model, num_classes, output_dim,
        base_lr=float(cfg.require("Optim.lr")),
        weight_decay=float(cfg.require("Optim.weight_decay")),
        total_steps=args.total_iter,
        power=float(cfg.get("Lr_Scheduler.power", 0.9)),
        min_lr=float(cfg.get("Lr_Scheduler.min_lr", 1e-4)),
        device=device)
    step_cfg = _step_config(cfg, strategy, distributed)
    return (state, step_cfg, make_train_step(step_cfg),
            make_eval_step(state.teacher, num_classes))


def _make_loaders(cfg, args, batch_size: int, num_shards: int = 1, shard_index: int = 0):
    """Train (labeled, unlabeled) and validation loaders of ``batch_size``
    (per device) over shard ``shard_index`` of ``num_shards``; the synthetic
    splits are sized from the global batch."""
    name = cfg.require("Dataset.name")
    num_classes = cfg.require("Network.num_class")
    canvas = tuple(cfg.get("Dataset.canvas_size", cfg.require("Dataset.crop_size")))
    train_spec, test_spec = build_dataset_specs(
        name, cfg.get("Dataset.data_dir", ""), canvas, num_classes,
        cache_dir=cfg.get("Dataset.cache_dir", None) or None)
    seed = cfg.get("Seed", 3407)
    global_batch = batch_size * num_shards
    if name == "Synthetic":
        labeled = [f"l{i}" for i in range(max(args.num_labels, global_batch))]
        unlabeled = [f"u{i}" for i in range(max(global_batch * 8, 64))]
        test = [f"v{i}" for i in range(global_batch * 2)]
    else:
        labeled, unlabeled, test = read_split_lists(cfg.require("Dataset.txt_dir"),
                                                    args.num_labels, seed)

    def mk(ids, spec, shuffle, drop):
        return BatchLoader(spec, ids, batch_size, seed=seed, shuffle=shuffle, drop_last=drop,
                           num_shards=num_shards, shard_index=shard_index)

    return (mk(labeled, train_spec, True, True), mk(unlabeled, train_spec, True, True),
            mk(test, test_spec, False, False))


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded by the tuple of counters ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _device_prefetch(batches, device: torch.device):
    """Yields each numpy batch of ``batches`` as tensors on ``device``.

    On the card the canvases go through pinned memory and a side stream,
    and batch n + 1's copy is started before batch n is yielded, so it runs
    under batch n's step; the compute stream waits for a batch's copy only
    when it takes the batch.
    """
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)

    def start_copy(batch):
        with torch.cuda.stream(copy_stream):
            return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                    for k, v in batch.items()}

    it = iter(batches)
    ahead = next(it, None)
    ahead = None if ahead is None else start_copy(ahead)
    while ahead is not None:
        current = ahead
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(copy_stream)
        for t in current.values():
            t.record_stream(compute)   # not reused by a later copy while in use
        ahead = next(it, None)
        ahead = None if ahead is None else start_copy(ahead)
        yield current


def _epoch_batches(train_l, u_iter):
    for batch_l in train_l:
        batch_u = next(u_iter)
        yield {"l_image": batch_l["image"], "l_label": batch_l["label"],
               "l_valid_hw": batch_l["valid_hw"], "u_image": batch_u["image"],
               "u_valid_hw": batch_u["valid_hw"]}


def _evaluate(eval_step, test_loader, crop, num_classes: int, seed: int, eval_index: int,
              device: torch.device, full_canvas: bool = False) -> ConfusionMatrix:
    """Teacher eval: one random crop of each validation image (the
    reference's test protocol; the crops of batch ``b`` drawn from
    ``(seed, eval_index, b)``), or with ``full_canvas`` the whole canvas for
    a sliding-window ``eval_step`` (the padded canvas carries label -1), the
    confusion matrix accumulated on the device, summed over the ranks (each
    evaluates its shard) and read once at the end."""
    mat = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for bi, batch in enumerate(_device_prefetch(test_loader, device)):
        img = to_channel_first(batch["image"].float() / 255.0)
        lab = batch["label"]
        lab = torch.where((lab >= 0) & (lab < num_classes), lab, -1)
        b, _, hh, ww = img.shape
        if full_canvas:
            img_c, lab_c = img, lab[:, None]
        else:
            draws = sample_augment_draws(_generator(device, seed, eval_index, bi), b, (1.0, 1.0),
                                         photometric=False)
            img_c, lab_c, _ = batch_transform(img, lab[:, None], img.new_zeros((b, 1, hh, ww)),
                                              batch["valid_hw"], crop, **draws.as_kwargs())
        mat = eval_step(mat, to_channel_last(normalize_imagenet(img_c)), lab_c[:, 0],
                        batch["valid"])
    if parallel.is_initialized():
        mat = parallel.all_reduce_sum(mat)
    cm = ConfusionMatrix(num_classes)
    cm.update(mat.cpu().numpy())
    return cm


_FAULT_TYPES = tuple(t for t in (torch.cuda.OutOfMemoryError,
                                 getattr(torch, "AcceleratorError", None)) if t is not None)
# cuBLAS's status errors read "CUDA error: CUBLAS_STATUS_..."
_FAULT_PREFIXES = ("CUDA error", "CUDA driver error", "cuDNN")


def _runtime_fault(err: BaseException) -> bool:
    """True for the runtime's faults, the counterpart of JAX's
    ``JaxRuntimeError``: the allocator's ``OutOfMemoryError``, a CUDA error
    (``torch.AcceleratorError``; a ``RuntimeError`` reading "CUDA error" on
    older torch), and the cuDNN and cuBLAS status errors."""
    return isinstance(err, _FAULT_TYPES) or (isinstance(err, RuntimeError)
                                             and str(err).startswith(_FAULT_PREFIXES))


def _drop_traceback(err: BaseException) -> None:
    """Drops ``err``'s traceback (its message and class stay): its frames
    hold the failed attempt's activations and autograd graph, which must be
    freed before the next attempt (clearing the frames' locals is not
    enough: ``nn.Module``'s call keeps its output in closure cells)."""
    err.__traceback__ = None


def _ranks_fault(err: BaseException, what: str, rank: int, world: int, save_dir: str):
    return RuntimeError(
        f"{what} failed on rank {rank} of {world} ({type(err).__name__}: {err}); a fault is not "
        f"recovered over more than one rank (a rank that ran again would reissue collectives "
        f"its peers already matched): restart with --resume "
        f"{os.path.join(save_dir, 'last_model')}")


class _HostRecovery:
    """Host copy of the train state, refreshed at eval points.

    A step that failed at or after its commit leaves a half-updated state
    that cannot run again in place; with a host snapshot such a fault costs
    at most one eval interval of progress instead of the run.  The snapshot
    holds what ``state_sha256`` hashes: the step, the student's and the
    teacher's tensors, the momentum buffers and the prototypes (about 0.67
    GiB for ResNet-101), in host buffers (pinned for a state on the card)
    allocated once.  ``every`` (``Training_Setting.host_recovery``): epochs
    between refreshes at eval points; 0 disables the snapshot.
    """

    def __init__(self, every: int = 1):
        self.every = every
        self.step = self.epoch = None
        self.tensors = self.momenta = None
        self.has_momentum = []

    @staticmethod
    def _live(state):
        """(the tensors every state holds, the parameters, their momentum
        buffers or None)."""
        params = list(state.model.parameters())
        momenta = [state.optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
        tensors = (list(state.model.state_dict().values())
                   + list(state.teacher.state_dict().values()) + [state.prototypes])
        return tensors, params, momenta

    @staticmethod
    def _host_like(t: torch.Tensor) -> torch.Tensor:
        return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="cpu",
                                   pin_memory=t.is_cuda)

    def refresh(self, state, epoch: int) -> None:
        if not (self.every and (epoch % self.every == 0 or self.step is None)):
            return
        tensors, _, momenta = self._live(state)
        if self.tensors is None:
            self.tensors = [self._host_like(t) for t in tensors]
            self.momenta = [None] * len(momenta)
        for host, t in zip(self.tensors, tensors):
            host.copy_(t, non_blocking=True)
        for i, m in enumerate(momenta):
            if m is not None:
                if self.momenta[i] is None:
                    self.momenta[i] = self._host_like(m)
                self.momenta[i].copy_(m, non_blocking=True)
        self.has_momentum = [m is not None for m in momenta]
        if tensors[0].is_cuda:
            torch.cuda.synchronize(tensors[0].device)
        self.step, self.epoch = state.step, epoch

    def nbytes(self) -> int:
        """The snapshot's size in bytes (0 before the first)."""
        if self.step is None:
            return 0
        return sum(t.nbytes for t in self.tensors) + sum(
            m.nbytes for m, has in zip(self.momenta, self.has_momentum) if has)

    def restore(self, state) -> bool:
        """Copies the snapshot back into ``state`` in place (the optimizer's
        parameters, their layout and the teacher stay the same objects);
        False when there is none."""
        if self.step is None:
            return False
        tensors, params, momenta = self._live(state)
        with torch.no_grad():
            for t, host in zip(tensors, self.tensors):
                t.copy_(host, non_blocking=True)
            for p, m, host, has in zip(params, momenta, self.momenta, self.has_momentum):
                if not has:        # the snapshot predates this parameter's first update
                    state.optimizer.state[p].pop("momentum_buffer", None)
                elif m is None:
                    state.optimizer.state[p]["momentum_buffer"] = host.to(p.device, copy=True)
                else:
                    m.copy_(host, non_blocking=True)
        state.step, state.consumed = self.step, False
        return True


def _recover_and_rerun(run, state, recovery: _HostRecovery, log, err):
    """Fault path of one train step: ``run(state)`` raised ``err``, a runtime
    fault.  A step that failed before its commit gave the state back as it
    was given, so it runs again in place (with the same draws: they are a
    function of the step).  If that fails too, or the state was consumed (the
    fault struck at or after the commit), the host snapshot is copied back
    and THIS batch runs again from it, with the draws of the snapshot's step;
    a third failure propagates."""
    _drop_traceback(err)
    retry_error = None
    if state.consumed:
        log.info(f"WARNING train step failed ({err}) at or after its update, which consumed "
                 "its state; not retrying in place")
    else:
        log.info(f"WARNING train step failed ({err}); retrying once")
        try:
            return run(state)
        except RuntimeError as e2:
            if not _runtime_fault(e2):
                raise
            _drop_traceback(e2)
            retry_error = e2
    try:
        restored = recovery.restore(state)
    except RuntimeError as e3:
        if not _runtime_fault(e3):
            raise
        # a sticky fault (an illegal address, a device-side assert) refuses
        # every later copy: the original fault comes out, not this one
        raise RuntimeError(
            f"train step failed ({err}), and copying the recovery snapshot back failed too "
            f"({e3}): the device is in an error state; restart the run with --resume from "
            "last_model") from err
    if not restored:
        if state.consumed:
            # the original fault, not the step's refusal of a consumed state
            raise RuntimeError(
                "train step failed at or after its update, so its state was consumed; no "
                "recovery snapshot available (Training_Setting.host_recovery=0?) — original "
                f"error: {err}") from err
        raise retry_error
    failed = "train step failed" if retry_error is None else f"retry failed ({retry_error})"
    log.info(f"WARNING {failed}; restored host recovery snapshot from epoch {recovery.epoch} "
             "and continuing the epoch")
    return run(state)


def _contrast_weight(cfg, args, strategy: str, epoch: int) -> float:
    """1 for ``ori``; the ``Ramp_Scheduler`` ramp-down at ``epoch`` for
    ``mix`` and ``cross`` when ``--sche`` is on, else 1."""
    if strategy == "ori" or not args.sche:
        return 1.0
    return rampdown_value(epoch, cfg.get("Ramp_Scheduler.begin_epoch", 0),
                          cfg.get("Ramp_Scheduler.max_epoch", 200),
                          cfg.get("Ramp_Scheduler.max_value", 1.0),
                          cfg.get("Ramp_Scheduler.min_value", 0.0),
                          cfg.get("Ramp_Scheduler.ramp_mult", -5.0))


def run_training(strategy: str, args) -> dict:
    """Trains ``strategy`` as ``args`` (the entry point's flags) say; returns
    ``{"best_miou", "steps", "preempted", "steps_per_sec"}`` (rank 0's; in
    a process group also ``world_size`` and each rank's ``state_sha256``).

    Under ``torchrun`` this process trains as its rank; with
    ``--num_devices N`` > 1 it starts N processes, one per device, and
    returns rank 0's result; otherwise it trains here, on one device."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (one of {STRATEGIES})")
    if parallel.launched_by_torchrun() and not parallel.is_initialized():
        device = parallel.init_from_env(torch.device(args.device).type)
        try:
            return train_on(device, strategy, args)
        finally:
            torch.distributed.destroy_process_group()
    device = resolve_device(args.device)
    devices = parallel.rank_devices(device, args.num_devices)
    world = len(devices)
    # what the step refuses (an unknown mode or loss) is refused before any
    # file is written or any rank starts
    cfg = load_config(args.config)
    _apply_cli_shadows(cfg, args, strategy)
    make_train_step(_step_config(cfg, strategy, distributed=world > 1))
    if world == 1:
        return train_on(device, strategy, args)
    return parallel.spawn(train_on, (strategy, args), world, parallel.backend_for(device),
                          devices)[0]


def train_on(device: torch.device, strategy: str, args) -> dict:
    """The training loop of one rank on ``device`` (of the default process
    group when there is one; alone otherwise); returns its result."""
    cfg = load_config(args.config)
    _apply_cli_shadows(cfg, args, strategy)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    distributed = parallel.is_initialized()
    rank, world = parallel.rank(), parallel.world_size()
    seed = cfg.get("Seed", 3407)
    batch_size = cfg.require("Dataset.batch_size")      # per device
    save_dir = os.path.join(cfg.get("Training_Setting.save_dir", "./checkpoints"),
                            str(args.job_name))
    log = Logger(os.path.join(save_dir, "train.log"), rank=rank)
    tb = ScalarWriter(os.path.join(save_dir, "tb"), rank=rank)
    guard = PreemptionGuard(cfg.get("Training_Setting.preempt_check_every", 10), device)
    loaders = ()
    try:
        if rank == 0:
            dump_config(cfg, save_dir)
        log.info(f"device={device} strategy={strategy} batch={batch_size}+{batch_size}"
                 + (f" per rank, {world} ranks" if distributed else ""))
        state, step_cfg, train_step, eval_step = _build_state_and_steps(cfg, args, device,
                                                                        strategy, distributed)
        loaders = train_l, train_u, test_loader = _make_loaders(cfg, args, batch_size, world,
                                                                rank)
        log.info(decoder_line(cfg.require("Dataset.name")))
        if len(train_l) == 0:
            # drop_last leaves no batch: the epoch loop would run no step
            raise ValueError(
                f"labeled split too small: {args.num_labels} labels make fewer than one "
                f"batch of {batch_size} per rank over {world} rank(s) (drop_last). Lower "
                f"Dataset.batch_size or raise --num_labels.")
        steps_per_epoch = len(train_l)
        total_epoch = max(int(args.total_iter / steps_per_epoch), 1)
        log.info(f"total epochs: {total_epoch} ({steps_per_epoch} steps/epoch)")

        start_epoch, best_miou = 0, 0.0
        if args.resume:
            if os.path.exists(args.resume):
                state, start_epoch, best_miou = restore_checkpoint(args.resume, state)
                log.info(f"resumed from {args.resume} at epoch {start_epoch} "
                         f"step {state.step}")
            else:
                log.info(f"WARNING --resume {args.resume} does not exist; starting afresh")
        proto_resume = getattr(args, "prototypes_resume", "")
        if proto_resume:
            if os.path.exists(proto_resume):
                state = load_prototypes(proto_resume, state)
                log.info(f"prototypes seeded from {proto_resume}")
            else:
                log.info(f"WARNING --prototypes_resume {proto_resume} does not exist; ignored")
        if distributed:   # one state on every rank, as JAX's replicated state
            parallel.broadcast_(list(state.model.state_dict().values())
                                + list(state.teacher.state_dict().values()) + [state.prototypes])
        warmup = getattr(args, "warmup", 0)

        h, w = state.model.output_hw(step_cfg.crop_hw)
        rep_pixels = 2 * batch_size * h * w
        timer = StepTimer()
        u_iter = InfiniteLoader(train_u, start_epoch)
        # over more than one rank a fault propagates: no snapshot to keep
        recovery = _HostRecovery(0 if distributed
                                 else cfg.get("Training_Setting.host_recovery", 1))
        recovery.refresh(state, start_epoch)     # covers faults before the first eval
        guard.install()
        done = preempted = False
        for epoch in range(start_epoch, total_epoch):
            train_l.set_epoch(epoch)
            weight = _contrast_weight(cfg, args, strategy, epoch)
            use_rep = strategy == "cross" and epoch >= warmup
            profiled = bool(args.profile_dir) and epoch == start_epoch
            with maybe_profile(args.profile_dir, profiled):
                batches = _device_prefetch(_epoch_batches(train_l, u_iter), device)
                for si, batch in enumerate(batches):
                    def run(s, batch=batch, weight=weight, use_rep=use_rep):
                        draws = sample_step_draws(_generator(device, seed + 1, s.step, rank),
                                                  step_cfg, batch_size, batch_size, rep_pixels)
                        return train_step(s, batch, draws, weight, use_rep)

                    try:
                        state, metrics = run(state)
                    except RuntimeError as e:
                        if not _runtime_fault(e):
                            raise
                        if distributed:
                            raise _ranks_fault(e, "train step", rank, world, save_dir) from e
                        state, metrics = _recover_and_rerun(run, state, recovery, log, e)
                    timer.tick()
                    if args.max_steps and state.step >= args.max_steps:
                        done = True
                        break
                    if guard.should_stop(si):
                        preempted = done = True
                        break
            # the profiled epoch's spans (utils/profiling.py), a step, on its log line
            spans = ""
            if profiled:
                spans = " " + per_step_line(snapshot())
                reset()

            if preempted:
                # skip eval; saved with this epoch so --resume replays it
                log.info(f"SIGTERM: preemption checkpoint at epoch {epoch} step "
                         f"{state.step}; exiting cleanly")
                if rank == 0:
                    save_checkpoint(os.path.join(save_dir, "last_model"), state, epoch,
                                    best_miou)
                break

            if not (strategy == "ori" or epoch % 20 == 0 or epoch > total_epoch - 50 or done
                    or epoch == total_epoch - 1):
                log.info(f"Epoch:{epoch} * Time {time.asctime()} {timer.summary()}{spans}")
                continue
            try:
                miou = _evaluate(eval_step, test_loader, step_cfg.crop_hw, step_cfg.num_classes,
                                 seed, epoch, device).miou
            except RuntimeError as e:
                if not _runtime_fault(e):
                    raise
                if distributed:
                    raise _ranks_fault(e, "eval", rank, world, save_dir) from e
                # a transient fault must not end a long run: skip this eval
                _drop_traceback(e)
                log.info(f"WARNING eval failed ({type(e).__name__}: {e}); "
                         "skipping this evaluation")
                miou = -1.0
            best_miou = max(best_miou, miou)
            m = {k: float(v) for k, v in metrics.items()}
            tb.scalars(state.step, {"eval/miou": miou, "loss/total": m["total"],
                                    "loss/sup": m["sup"], "loss/unsup": m["unsup"],
                                    "loss/contrast": m["contrast"]})
            log.info(f"Epoch:{epoch} * mIoU {miou:.4f} Best_mIoU {best_miou:.4f} "
                     f"loss {m['total']:.4f} (sup {m['sup']:.4f} unsup {m['unsup']:.4f} "
                     f"contrast {m['contrast']:.4f}) {timer.summary()} Time {time.asctime()}"
                     f"{spans}")
            if rank == 0:
                if miou >= best_miou:
                    save_checkpoint(os.path.join(save_dir, "best_model"), state, epoch + 1,
                                    miou)
                # rolling recovery point, stamped with the best mIoU so that
                # a resume cannot lower the bar for best_model
                if epoch % 10 == 0 or done or epoch == total_epoch - 1:
                    save_checkpoint(os.path.join(save_dir, "last_model"), state, epoch + 1,
                                    best_miou)
            recovery.refresh(state, epoch)
            if done:
                break
    finally:
        guard.uninstall()
        for loader in loaders:
            loader.close()
        log.close()
        tb.close()
    result = {"best_miou": best_miou, "steps": state.step, "preempted": preempted,
              # steady-state wall rate of the whole loop (decode, copy, step),
              # the first interval left out
              "steps_per_sec": timer.steps_per_sec}
    if distributed:
        digests = [None] * world
        torch.distributed.all_gather_object(digests, state_sha256(state))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks' states differ after training: {digests}")
        result.update(world_size=world, state_sha256=digests)
    return result
