#!/usr/bin/env python3
"""Drives css_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--steps N]

Phases, in order; any failure ends the run with a traceback and a non-zero
exit code, and no result line.  The train steps run as the entry point
runs them: on the card, outside ``distributed``, a step function's first
call of a key is eager, the next captures the step in CUDA graphs
(``train/graph_step.py``) and later calls replay them; the blocks that
compare the per-class path hold every step eager (``_eager_steps``).
Launch counts: the kernels' counters count wrapper calls, which a step
makes when its Python runs (eagerly or under the capture) and a replay does
not; so "a step" below is such a step, a block's calls less its replays
(``REPLAYS``).  Each runs the contrastive loss once, and a loss call
launches ``class_live_rows`` (every class's compaction) once and K1 and K2
once per class, 21 times a VOC step and 19 a Cityscapes step, and the
one-vector compaction ``live_rows_compact`` never; "each kernel launched k
times a step" below counts K1 and K2, with ``class_live_rows`` once a step
beside them.  Every block of timed steps (phases 5, 6, 6b, 9, 9b, 10 and
14), its warm-up included, also counts its train-mode BatchNorm calls on
the card (``_BnCalls``) and fails unless each launched the BatchNorm
kernels: statistics and output once a call, the statistics' finish once
more under ``distributed``, the two backward kernels once a call that
builds a graph; the final line keeps each block's counts under
``batchnorm_steps``.  The main steps (phases 5, 9 and 9b) must replay
graphs in every timed step, and their replayed state must equal an eager
run's from the same state, batch and draws (``_graph_vs_eager``).

1. header: the card (``nvidia-smi``), torch and CUDA versions, TF32 flags;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: the one-vector live-row compaction, K1 and K2 at the main-path shapes
   (Q = 256 anchors, D = 256, N = 262,144 table rows), held against their
   plain PyTorch versions on the same inputs under three weight patterns:
   a dead half, the thinned multiplicities the main path feeds them (on the
   labeled half), and thinned multiplicities scattered over the whole
   table; then timed, with the L2 flushed before each call, beside the
   plain versions, a library yardstick and the least time the card could
   take for the same work; then the same, thinned only, at the Cityscapes
   table (N = 8 x 193^2 = 297,992 rows, a multiple of neither tile); then
   every class's compaction, ``class_live_rows``, at VOC's C = 21 and
   Cityscapes' C = 19 classes (80% of the rows members, one class without
   members), thinned with seeded uniforms and as ``expected_pallas`` feeds
   it, equal to its plain version in every count, index and weight, and
   timed beside its plain version, the per-class path it replaced (gather,
   thinning and ``compact_live_rows_kernel`` per class) and ``torch.nonzero``
   of the [C, N] weights;
3b. batchnorm: the fused train-mode BatchNorm kernels (stats, apply,
   grad_stats, grad_apply) at the main path's shapes (``BN_SHAPES``: VOC
   layer3's conv2 and conv3 with the shortcut, Cityscapes' layer3 conv3 in
   two groups, the ASPP pool in two groups, the decoder's 48-channel
   projection; bf16), each held against its plain version on the same
   inputs (at most one bf16 step apart in norm, the f32 sums to 1e-4); the
   statistics kernel and the finish (``css_bn_finish``, the distributed
   path's) also move copies of seeded running stats against the plain
   versions' (to 1e-4), and the finish's statistics are held against the
   plain finish's on the same sums; then
   timed with the L2 flushed before each call beside its plain version and
   the least time the card could take for its bytes; then the whole BN
   (forward, and forward + backward through autograd) three ways: the
   kernels, the module's own eager code, and ATen's ``F.batch_norm`` with
   the add and the ReLU as the library yardstick, which the port never
   calls;
4. contrastive: the port's contrastive loss and its gradient at a small
   input on the card (through K1/K2) against the same call on the CPU
   (through the plain versions); then one full-size VOC loss (N = 262,144,
   21 classes) through ``class_live_rows`` and on the per-class path:
   loss, prototypes and gradient bit-equal;
5. train: the flagship ``ori`` step -- ResNet-101 OS8 DeepLabV3+ dual head,
   21 classes, 512x512 crops, 8 labeled + 8 unlabeled images, CutMix,
   ``sampled_pallas`` negatives, bf16 compute, random weights from a seed,
   synthetic data -- 2 warm-up steps (the eager one and the capture), then
   ``--steps`` timed replays, the kernel launch counters zeroed before the
   warm-up and read after: every loss must be finite, each kernel must
   launch once per class per step, and the peak device memory of the
   block must stay within PEAK_GIB_LIMIT; then three steps replayed and
   three eager from copies of the state, bit-equal (``_graph_vs_eager``);
   then ``--steps`` eager steps a block through ``class_live_rows`` and on
   the per-class path in turns (batched, per-class, per-class, batched,
   twice), each block's launches checked, and the ratio of their ms/step
   (the fused Cityscapes step likewise in phase 9);
6. strategies: ``mix``, then ``cross``, continuing the train phase's state
   (so the prototypes are real) with their entry points' thresholds
   (strong 0.8, weak 0.7, unsupervised 0.97, representation temperature
   0.5): 1 warm-up + ``--steps`` timed steps each, ``cross`` timed with the
   representation-space labels after a warm-up on the logit-space ones; it
   fails unless every loss is finite, each kernel launched 21 times a step
   and the phase's peak memory stays within STRATEGIES_PEAK_GIB_LIMIT, and
   prints each strategy's ms/step beside the train phase's ``ori`` ms/step
   and the share of valid unlabeled pixels that keep a label in the eager
   steps (for ``mix``, where the two label spaces agree);
6b. opt-in steps, continuing the train phase's state: a full-size VOC
   ``ori`` step (1 warm-up + ``--steps`` timed) in ``sampled_pallas`` (the
   yardstick, timed in this phase) and in each of the negative modes
   ``expected`` (the plain product), ``expected_pallas`` (K1/K2 on dense
   weights) and ``sampled`` (gathered negatives), each with finite losses,
   its ms/step beside ``sampled_pallas``'s and its peak memory; the
   ``_pallas`` modes must launch each kernel 21 times a step (and
   ``class_live_rows`` once), the others none.  The ``expected_pallas`` warm-up step records the contrastive
   loss's inputs, on which the loss in ``expected_pallas`` must equal the
   loss in ``expected`` to 2e-3, and its first class's dense weights, on
   which K1, K2 and the one-vector compaction are checked against their
   plain versions and timed as in the kernel phase, as is
   ``class_live_rows`` on the step's own inputs.  Then one step under the uint8
   augmentation law (``aug_quantize``), and ``batch_transform(quantize=
   True)`` with the photometric ops on one labeled batch on the card
   against the same call on the CPU with the same draws: at most one uint8
   step apart (the share of exact pixels is printed; all are expected),
   labels and confidences equal;
7. cross entry point: with the state freed, ``cross`` through its entry
   point's parser (shipped VOC YAML, ``--synthetic --num_labels 16
   --total_iter 4 --warmup 1``: 2 epochs of 2 steps, an eval after each) in
   a temporary directory; it fails unless the losses are finite, the steps
   ran with the ramp-down weights of epochs 0, 0, 1, 1 and switched to the
   representation-space labels at step 3, both evals counted every valid
   label pixel and each kernel launched 84 times (4 steps);
8. driver: with the train phase's state freed, the port's own entry point
   (``css_tpu_torch.cli``, through its argument parser) runs twice on the
   shipped VOC YAML with ``--synthetic``, in a temporary directory removed
   at the end: run A ``--num_labels 32 --total_iter 4 --max_steps 4`` (4
   steps, one eval over the 16 synthetic val images, checkpoints), then run
   B ``--resume`` from A's ``last_model`` with ``--total_iter 8 --max_steps
   6``.  The kernel launch counters are zeroed before A.  It fails unless
   every loss is finite, each eval's confusion-matrix total equals the
   count of valid label pixels in its crops, B starts at step 4 with the
   prototypes A saved (bit-equal) and ends at step 6, and each kernel
   launched 21 x 6 times.  It prints the driver's steps/s and ms/step
   (beside the train phase's bare step), eval ms per image, checkpoint
   seconds, the phase's peak memory, and the loader's ms per batch alone;
8b. opt-in entry points, on run B's ``last_model``: ``evaluate``
   (``--synthetic --num_labels 32``, the teacher, one crop per image) must
   print a confusion matrix equal to the driver's ``_evaluate`` on the same
   checkpoint with the same eval number; the sliding-window eval at the
   Cityscapes shapes (random weights, 769^2 windows over 1024 x 2048
   canvases, 8 a canvas: 2 canvases plain, 1 with a flip and scales 0.75
   and 1.0) must count every valid label pixel once, and prints ms per
   image; ``predict`` with ``--overlay`` on 4 images of mixed sizes, one
   larger than the canvas, must write each mask and overlay at its input's
   size;
9. cityscapes: with every earlier state freed and the peak counter reset,
   the shipped Cityscapes YAML's step (``css_tpu_torch/config/
   CityScapes_config_baseline.yaml`` through ``_build_state_and_steps``: 19
   classes, ResNet-101 OS8, 769x769 crops from a 1024x2048 canvas at scale
   0.5-2.0, 4 labeled + 4 unlabeled images, OHEM CE at 0.7 keeping at least
   50,000 pixels per image, the fused labeled + unlabeled forward with
   grouped BatchNorm, no remat) on a device-resident synthetic batch:
   first three steps replayed against three eager ones from copies of the
   state (``_graph_vs_eager``), then 2 warm-up + ``--steps`` timed steps; it
   fails unless every loss is finite, each kernel launched 19 times a step
   and the peak stays within CITY_PEAK_GIB_LIMIT, and prints ms/step,
   img/s, peak memory and OHEM's kept pixels and threshold in the eager
   step.  Then, in the same run: the step with two
   passes instead of the fused one (1 warm-up + ``--steps`` timed; both
   ms/step and their ratio), one ``mix`` step with the fused teacher pass
   (after a warm-up step), ``resnet101_stem`` with remat on (the default at
   769^2) under each remat policy, ``nothing`` and ``save_mid`` (1 warm-up
   + ``--steps`` timed each), each with its ms/step and peak, OHEM on the
   card without a host synchronisation against the CPU, and the ``ori``
   entry point on the shipped YAML (``--synthetic --num_labels 8
   --total_iter 2 --max_steps 2``: 2 steps and an eval) with finite losses,
   every valid label pixel counted and 38 launches per kernel (2 steps);
9b. segformer: the shipped SegFormer-B5 YAML's step (``css_tpu_torch/
   config/VOC_segformer_b5.yaml`` through ``_build_state_and_steps``: MiT-B5,
   the all-MLP decoder, 21 classes, 512x512, b8 + 8, bf16) on the train
   phase's batch: three steps replayed against three eager ones
   (``_graph_vs_eager``), then 2 warm-up + ``--steps`` timed steps with
   finite losses, 21 launches per kernel a step and the BN check (the
   decoder's and the representation head's), and ms/step, img/s and peak;
10. distributed: data parallelism (``css_tpu_torch/parallel``), in three
   parts.  (1) World size 1 over NCCL, in this process, at the VOC width:
   the shipped VOC YAML's ``ori`` step through ``_build_state_and_steps``
   with cross-replica BN and the step's all-reduces; its first step's
   losses are held against the non-distributed step from the same state
   copy and the same draws (rtol 1e-2: cuDNN may pick other algorithms),
   and the two states after it are compared by SHA-256 and printed (not
   checked, for the same reason), beside the plain step run twice from that
   copy; then 1 warm-up + ``--steps`` timed steps
   with 21 launches per kernel a step, ms/step beside the train phase's
   bare step and the peak; then one step at ``un_threshold`` 0 (every pixel
   passes) against the same step at 0.97, from copies of one state: the
   unsupervised loss must be finite and nonzero, and the student's gradient
   norm must differ.  (2) Two ranks
   through the driver's launcher (``parallel.spawn`` running
   ``train_main.train_on``) on the shipped VOC YAML, ``--synthetic``: 3
   steps and an eval, in a temporary directory; with two or more cards NCCL,
   one card each, at the YAML's b8 + 8 per rank; with one card both ranks on
   it over gloo (NCCL refuses two ranks on one GPU) at b4 + 4 per rank, the
   recipe's global batch.  It fails unless the losses are finite, the ranks'
   final states are bit-equal (a SHA-256 each), only rank 0 wrote the log
   and the checkpoints, the eval matrix counts the valid label pixels of
   both shards and each rank launched each kernel 21 times a step; each
   rank prints where its time went (the steps' start times, the eval and
   the saves).  (3) A one-process run resumes from (2)'s ``last_model`` and
   must start at its step with its prototypes, bit-equal.
11. import: a reference (PyTorch CSS) training checkpoint for ResNet-101,
   its names written out here (``resnet_*``, ``ASPP.convs.*``, ``project``,
   ``classifier``, ``representation``) and its tensors drawn from a seed,
   goes through ``entries import`` on the card; every tensor of the
   student and the teacher must land (the SHA-256 multisets equal, four
   named spot checks), with the prototypes, the epoch and a fresh
   optimizer.  The driver then resumes from it for 2 steps on the shipped
   VOC YAML (finite losses, 21 launches per kernel a step, an eval that
   counts every valid label pixel), and ``evaluate`` reads it;
12. files: a VOC-layout tree (16 JPEGs at 500 x 375 or 375 x 500 with
   palette PNG labels, split lists) and a Cityscapes-layout one (8 RGB PNGs
   at 2048 x 1024 with trainIds labels), written from a seed; the decoder
   line (``native`` or ``pil`` and why); every file decoded by the host
   decoder must equal PIL on every pixel; the loader alone in ms per batch
   with the host decoder and with PIL (alternating, 2 passes each, twice)
   for both recipes; then 2 driver steps and an eval on the VOC tree, whose
   ``train.log`` must name the decoder;
13. evaluate-ranks: ``evaluate`` of the imported checkpoint on the files
   phase's VOC tree at b1 in this process, ``evaluate --num_devices 1``
   inside a 1-rank NCCL group, and ``evaluate_on`` over two gloo ranks on
   one card, all with cuDNN's deterministic heuristic picks: both sharded
   matrices must equal the one-process one;
14. os16: the VOC ``ori`` step at output stride 16 (ASPP rates 6, 12, 18)
   and at 8, 1 warm-up + ``--steps`` timed each from random weights: finite
   losses, 21 launches per kernel a step, ms/step and peak of each;
15. recovery: the driver's fault recovery through the entry point on the
   shipped VOC YAML (``ori``, ``--synthetic --num_labels 16 --total_iter
   6``: 3 epochs of 2 steps, an eval after each; the checkpoints are
   recorded, not written), with real allocator failures on the card (an
   allocation of the card's whole memory and 1 GiB more) injected from
   inside the step by patching.  Each run's step is eager in its first
   attempt, captured in its second and replayed from then on.  (a)
   Unfaulted.  (b) A forward hook on the student's trunk fails in the 1st
   attempt (eager), after the teacher's and the student's BN stats moved:
   the state the retry is given must equal, by SHA-256, the state the
   failed attempt was given, the run must end at step 6, and its final
   state must equal (a)'s bit for bit.  Both run
   under ``torch.use_deterministic_algorithms`` and cuDNN's deterministic
   picks (by default two runs on the card differ in the last bits); where
   they still differ, a second unfaulted run (a2) says whether the card or
   the retry is the cause, and the phase fails only for the retry.
   (c) The 4th attempt, a replay, fails before its graphs launch, which is
   after the commit (the step marks the state consumed before a replay):
   the snapshot of epoch 0 is restored, the attempts start at steps 0, 1,
   2, 3, 2, 3, 4 (as ``css_tpu`` rewinds), the losses stay finite and the
   run ends at step 5.  (d) The hook fails in every attempt: the retry in
   place fails, the snapshot is restored, and the third failure must
   propagate as an OutOfMemoryError with the first one in its context.  (e)
   ``Training_Setting.host_recovery: 0`` and (c)'s fault: a RuntimeError
   naming the key, caused by the fault.  (f) The first eval fails: the log
   reads mIoU -1, no ``best_model`` is saved at that epoch, the snapshot is
   refreshed, and the run ends at step 4.  Each run's launches must be
   one loss's per attempt that reached the contrastive loss in Python
   (eager or captured).  It prints the
   snapshot's GiB and seconds per refresh, the retry's and the restore's
   wall times and the peaks of (a) and (b).  (g) ``distributed_init``
   through ``COORDINATOR_ADDRESS=127.0.0.1:<free port>`` with one process
   joins a 1-rank NCCL group and all-reduces a tensor.

The output ends with one JSON line of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
Q, D = 256, 256
N_VOC = 262_144                 # 16 images x 128^2 representation pixels
N_CITY = 297_992                # 8 images x 193^2 (769^2 crops)
INV_TEMP = 2.0                  # 1 / temp, temp = 0.5
NUM_NEGATIVES = 512
K1_RTOL = 1e-3                  # same bf16 products, f32 sums in another order
K2_RTOL = 1e-2                  # plus K2's bf16 exp: one bf16 step (2^-8) may flip
K2_ATOL_FRACTION = 1e-2         # of max |M|
PEAK_GIB_LIMIT = 18.135         # the step's peak with the fused BatchNorm (18.035 GiB)
                                # + 0.1 GiB
STRATEGIES_PEAK_GIB_LIMIT = 18.165   # the phase's reading with it (18.065 GiB) + 0.1 GiB
CITY_PEAK_GIB_LIMIT = 20.688    # the fused step's reading with it (20.588 GiB) + 0.1 GiB
BN_SHAPES = (   # (label, [N, C, H, W], groups, residual, relu): the main path's BNs
    ("voc_layer3_conv2", (8, 256, 64, 64), 1, False, True),
    ("voc_layer3_conv3", (8, 1024, 64, 64), 1, True, True),
    ("city_layer3_conv3", (8, 1024, 97, 97), 2, True, True),
    ("aspp_pool", (8, 256, 1, 1), 2, False, True),
    ("projection_48", (8, 48, 128, 128), 1, False, True),
)
CITY_YAML = "CityScapes_config_baseline.yaml"
VOC_YAML = "VOC_config_baseline.yaml"
SEGFORMER_YAML = "VOC_segformer_b5.yaml"
FAILED_CAPTURE_GIB_LIMIT = 4.0  # reserved beyond the live tensors after a failed capture
                                # (0.8 GiB after a collection with no graph; a step's
                                # capture holds 18-20)
DIST_LOSS_RTOL = 1e-2           # world-1 NCCL step vs the plain step: cuDNN's picks may differ


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


FLUSH_KERNEL = "bitwise_not"   # the L2 flush's kernel, left out of device times
FIRST_KERNEL = "class_live_rows"   # the first kernel of the loss's path: every class's
                                   # compaction, one launch a loss call
COMPACT_KERNEL = "count_live"  # the first kernel of every wrapper call that compacts one vector


def _want_launches(calls: int, c: int) -> dict:
    """The launches of ``calls`` contrastive-loss calls over ``c`` classes:
    one compaction of every class each, K1 and K2 once per class, and no
    compaction of a single weight vector."""
    return {"class_live_rows": calls, "live_rows_compact": 0,
            "weighted_exp_softsum_fwd": c * calls, "weighted_exp_softsum_bwd": c * calls}


def _check_launches(label: str, launches: dict, calls: int, c: int = 21) -> None:
    want = _want_launches(calls, c)
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")


REPLAYS = [0]           # train-step calls that replayed graphs captured before
_HOLD_EAGER = [False]   # True inside _eager_steps()


def _watch_step_graphs(torch):
    """Wraps ``StepGraphs.prepare`` (``train/graph_step.py``) for the whole
    script: counts in ``REPLAYS`` each train-step call that replays graphs
    captured before (a call that captures runs the step's Python once, under
    the capture, as an eager call does; a replay runs none, so a block's
    steps that the launch counters and ``_BnCalls`` see are its calls less
    its replays); returns None, so that the step runs eagerly, inside
    ``_eager_steps()``; and where a capture fails (the step then runs
    eagerly, for good, with a warning), puts the kernels' counters and the
    open ``_BnCalls``' counts back as they stood before it (the capture ran
    nothing on the card), and fails unless the capture's memory went back to
    the allocator (``FAILED_CAPTURE_GIB_LIMIT``)."""
    import gc

    from css_tpu_torch.ops.kernels import batchnorm_kernels as bk
    from css_tpu_torch.ops.kernels import contrastive_kernels as ck
    from css_tpu_torch.train.graph_step import StepGraphs

    real = StepGraphs.prepare

    def prepare(self, *args):
        if _HOLD_EAGER[0]:
            return None
        captures, failed = self.captures, self.failed
        before = dict(ck.LAUNCHES), dict(bk.LAUNCHES), [b.counts() for b in _BnCalls.OPEN]
        replay = real(self, *args)
        if replay is not None and self.captures == captures:
            REPLAYS[0] += 1
        if self.failed is not None and failed is None:
            ck.LAUNCHES.update(before[0])
            bk.LAUNCHES.update(before[1])
            for b, counts in zip(_BnCalls.OPEN, before[2]):
                b.calls, b.distributed, b.graphs = counts
            # and the capture's memory went back: what stays reserved after a
            # collection is the live tensors' and their segments' slack
            gc.collect()
            torch.cuda.empty_cache()
            kept = (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / 2**30
            print(f"train step: CUDA graph capture failed, eager from now on ({self.failed}); "
                  f"reserved beyond the live tensors after it: {kept:.3f} GiB", flush=True)
            if kept > FAILED_CAPTURE_GIB_LIMIT:
                raise RuntimeError(f"a failed capture kept {kept:.3f} GiB reserved")
        return replay

    StepGraphs.prepare = prepare


@contextlib.contextmanager
def _eager_steps():
    """Inside, every train step runs eagerly (``_watch_step_graphs``)."""
    _HOLD_EAGER[0] = True
    try:
        yield
    finally:
        _HOLD_EAGER[0] = False


BN_STEP_LAUNCHES = {}   # label -> the BN kernels' launches and calls of its timed steps


class _BnCalls:
    """Counts, inside, the train-mode ``GroupedBatchNorm`` calls on CUDA
    tensors (a global forward pre-hook) beside the BN kernels' launches.
    ``check`` fails unless there were calls and each launched the
    statistics and the output kernel once, the finish once more where the BN
    is ``distributed``, and, where it builds a graph, the two backward
    kernels once: a remat recompute (``update_stats`` off) launches the
    forward again, not the backward.  It keeps the launches, the calls and
    ``fallback`` (calls less statistics launches: calls that took another
    path) in ``BN_STEP_LAUNCHES[label]``.  A replayed step calls no module:
    the counts are of the steps whose Python ran (``_watch_step_graphs``)."""

    OPEN = []       # the instances inside their ``with``

    def __init__(self, torch):
        from css_tpu_torch.models.resnet import GroupedBatchNorm
        from css_tpu_torch.ops.kernels import batchnorm_kernels as bk

        self.torch, self.bn_class, self.bk = torch, GroupedBatchNorm, bk
        self.calls = self.distributed = self.graphs = 0

    def _count(self, module, args):
        if not (isinstance(module, self.bn_class) and module.training and args[0].is_cuda):
            return
        self.calls += 1
        self.distributed += module.distributed
        tensors = [a for a in args if isinstance(a, self.torch.Tensor)]
        if self.torch.is_grad_enabled() and module.update_stats and any(
                t.requires_grad for t in tensors + [module.weight, module.bias]):
            self.graphs += 1

    def counts(self) -> tuple:
        return self.calls, self.distributed, self.graphs

    def __enter__(self):
        self.bk.reset_launches()
        self.handle = self.torch.nn.modules.module.register_module_forward_pre_hook(self._count)
        self.OPEN.append(self)
        return self

    def __exit__(self, *exc):
        self.OPEN.remove(self)
        self.handle.remove()

    def check(self, label: str) -> None:
        launches = dict(self.bk.LAUNCHES)
        want = {"css_bn_stats": self.calls, "css_bn_finish": self.distributed,
                "css_bn_apply": self.calls, "css_bn_grad_stats": self.graphs,
                "css_bn_grad_apply": self.graphs}
        BN_STEP_LAUNCHES[label] = dict(launches, train_bn_calls=self.calls,
                                       fallback=self.calls - launches["css_bn_stats"])
        print(f"{label}: BatchNorm {json.dumps(BN_STEP_LAUNCHES[label])}", flush=True)
        if launches != want or not self.calls:
            raise RuntimeError(f"{label}: BatchNorm launches {launches} for {self.calls} "
                               f"train-mode calls ({self.distributed} distributed, "
                               f"{self.graphs} with a graph); want {want}")


class _PerClassPath:
    """Puts the contrastive loss back on the per-class path that
    ``class_live_rows`` replaced: the batched compaction only records its
    inputs, and each class's K1/K2 call takes the class's weights as the loss
    built them (``p_over_cnt[c][masked_cls]``; in ``sampled_pallas`` thinned
    from G times them with ``u[c]``) through ``weighted_exp_softsum_stochastic``
    or ``weighted_exp_softsum``, which compact one vector at a time (21
    ``live_rows_compact`` launches a VOC loss)."""

    def __enter__(self):
        from css_tpu_torch.losses import contrastive
        from css_tpu_torch.ops.kernels import contrastive_kernels as ck

        self.module = contrastive
        self.real = contrastive.class_live_rows, contrastive.weighted_exp_softsum_live
        seen = {}

        def recording(p_over_cnt, masked_cls, g, u=None):
            seen.update(p=p_over_cnt, cls=masked_cls.long(), g=g, u=u, k=0)
            rows = [None] * p_over_cnt.shape[0]
            return rows, rows, rows

        def one_class(a, r, idx, wv, n_live, inv_temp):
            k = seen["k"]
            seen["k"] += 1
            w = seen["p"][k][seen["cls"]]
            if seen["u"] is None:
                return ck.weighted_exp_softsum(a, r, w, inv_temp)
            return ck.weighted_exp_softsum_stochastic(a, r, seen["g"] * w, inv_temp, seen["u"][k])
        contrastive.class_live_rows, contrastive.weighted_exp_softsum_live = recording, one_class
        return self

    def __exit__(self, *exc):
        self.module.class_live_rows, self.module.weighted_exp_softsum_live = self.real


def _l2_flush(torch):
    """A callable that sweeps a 256 MB buffer (five times the 50 MB L2)
    through the cache, so that the next call finds its rows in device memory,
    as each class's call does in the step."""
    buf = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    return buf.bitwise_not_


def _timed(torch, fn, iters: int, flush, marker: str = "", per_call: int = 1) -> tuple:
    """(ms, device_ms) per call of ``fn``, the L2 flushed before each call.
    ms: the median over the calls of CUDA events around each call (the
    median, since a stall of the shared host can hold one call's second
    event back).  device_ms (None without ``marker``): the summed durations
    of the calls' kernels from torch.profiler, without the host's gaps.
    ``marker`` names the first kernel of every call.  The profiler misses
    the first records of a window on the card (flushes and kernels alike),
    so the sum runs from the second call it saw on, over the calls after
    it; a window that lost more than two calls' markers is profiled again,
    up to three windows, and where each of them lost more, device_ms is
    None (printed as not measured): the profiler's losses are the card
    machine's, and ``ms`` is measured all the same.  ``per_call``: the
    marker's kernels in one call (the per-class path compacts once a class)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(start.elapsed_time(end) for start, end in events)
    if not marker:
        return ms, None
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            flush()
            torch.cuda.synchronize()
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in p.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in kernels if marker in e.name]
        seen.append(len(starts) / per_call)
        if len(starts) >= (iters - 2) * per_call:
            break
    else:
        print(f"device ms not measured: the profiler saw {seen} {marker} kernels of {iters} "
              f"calls in three windows", flush=True)
        return ms, None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels
                  if FLUSH_KERNEL not in e.name and e.time_range.start >= starts[per_call])
    return ms, busy_us / (len(starts) / per_call - 1) / 1e3


def _kernel_inputs(torch, ck, g, w_kind: str, n: int):
    dev = "cuda"
    a = torch.nn.functional.normalize(torch.randn(Q, D, device=dev, generator=g), dim=1)
    r = torch.nn.functional.normalize(torch.randn(n, D, device=dev, generator=g), dim=1)
    if w_kind == "dead_half":
        w = torch.rand(n, device=dev, generator=g)
        w[n // 2:] = 0.0
    else:   # thinned multiplicities around lam, sum(lam) = G, on the labeled half or all
        lam = torch.rand(n, device=dev, generator=g)
        if w_kind == "thinned":
            lam[n // 2:] = 0.0
        lam *= NUM_NEGATIVES / lam.sum()
        w = ck.thinned_multiplicities(torch.rand(n, device=dev, generator=g), lam)
    return a.to(torch.bfloat16), r.to(torch.bfloat16), w


def _bounds_ms(a, w, live: int):
    """Least time for each kernel on these inputs: K1 and K2 read the
    anchors, all weights and the live rows; the compaction reads the weights
    and writes an index and a weight per live row."""
    q, d = a.shape
    read = q * d * 2 + w.numel() * 4 + live * d * 2
    work = {"k1": (read + q * 4, 2 * q * d * live),
            "k2": (read + q * d * 4, 4 * q * d * live),
            "compact": (w.numel() * 4 + live * 8 + 4, 0)}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_FLOP_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def _class_inputs(torch, g, c: int, n: int):
    """``class_live_rows``' inputs as the loss builds them, at a step's
    density: 80% of the rows members, of every class but class 1 (no pixels,
    so no class weighs it), p the softmax over the other member classes of
    random prototype similarities / 0.5, and the uniforms [C, N]."""
    dev = "cuda"
    cls = torch.randint(0, c, (n,), device=dev, generator=g)
    cls[cls == 1] = 0
    member = torch.rand(n, device=dev, generator=g) < 0.8
    masked = torch.where(member, cls, torch.full_like(cls, c))
    counts = torch.bincount(masked, minlength=c + 1)[:c].float()
    sim = torch.randn(c, c, device=dev, generator=g) / 0.5
    allowed = ~torch.eye(c, dtype=torch.bool, device=dev) & (counts > 0)[None, :]
    p = torch.softmax(torch.where(allowed, sim, torch.full_like(sim, -torch.inf)), dim=-1)
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    p_over_cnt = torch.nn.functional.pad(p / counts.clamp_min(1.0)[None, :], (0, 1))
    return p_over_cnt, masked.int(), torch.rand(c, n, device=dev, generator=g)


def _class_bound_ms(c: int, n: int, thinned: bool, live: int):
    """Least time for every class's compaction: p_over_cnt, the rows'
    classes and (thinned) the uniforms read once, an index and a weight per
    live row and the C counts written; no arithmetic worth counting."""
    nbytes = c * (c + 1) * 4 + n * 4 + (c * n * 4 if thinned else 0) + live * 8 + c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _class_rows_row(torch, ck, flush, p_over_cnt, cls, g, u, label: str) -> dict:
    """``class_live_rows_kernel`` against its plain version (exactly, every
    class's count, indices and weights), then timed with the L2 flushed
    before each call beside the plain version, the per-class path it
    replaced (each class's gather, ``g *``, thinning and
    ``compact_live_rows_kernel``, from the same int64 classes the loss had)
    and ``torch.nonzero`` of every class's weights [C, N] at once."""
    c, n = p_over_cnt.shape[0], cls.shape[0]
    got = ck.class_live_rows_kernel(p_over_cnt, cls, g, u)
    torch.cuda.synchronize()
    want = ck.class_live_rows_plain(p_over_cnt, cls, g, u)
    counts = want[2].tolist()
    if not torch.equal(got[2], want[2]) or any(
            not (torch.equal(got[0][k, :m], want[0][k, :m])
                 and torch.equal(got[1][k, :m], want[1][k, :m])) for k, m in enumerate(counts)):
        raise RuntimeError(f"class_live_rows {label}: the kernel differs from its plain "
                           f"version (counts {got[2].tolist()} vs {counts})")
    cls_long = cls.long()
    weights = torch.stack([ck.thinned_multiplicities(u[k], g * p_over_cnt[k][cls_long])
                           if u is not None else p_over_cnt[k][cls_long] for k in range(c)])

    def per_class():
        for k in range(c):
            w = p_over_cnt[k][cls_long]
            ck.compact_live_rows_kernel(
                w if u is None else ck.thinned_multiplicities(u[k], g * w))

    live = sum(counts)
    bound, bound_by = _class_bound_ms(c, n, u is not None, live)
    ms, device_ms = _timed(torch, lambda: ck.class_live_rows_kernel(p_over_cnt, cls, g, u), 20,
                           flush, FIRST_KERNEL)
    per_ms, per_device_ms = _timed(torch, per_class, 20, flush, COMPACT_KERNEL, per_call=c)
    row = dict(classes=c, n=n, live_rows=live, classes_without_rows=counts.count(0),
               classes_without_members=int((torch.bincount(cls_long, minlength=c + 1)[:c] == 0)
                                           .sum()), ms=ms,
               device_ms=device_ms,
               plain_ms=_timed(torch, lambda: ck.class_live_rows_plain(p_over_cnt, cls, g, u),
                               5, flush)[0],
               bound_ms=bound, bound_by=bound_by,
               library_ms=_timed(torch, lambda: torch.nonzero(weights), 10, flush)[0],
               per_class_ms=per_ms, per_class_device_ms=per_device_ms, max_abs_err=0.0)
    print(f"kernel class_live_rows {label}: " + json.dumps(row), flush=True)
    return row


def _check_compaction(torch, ck, w):
    idx, wv, n_live = ck.compact_live_rows_kernel(w)
    idx_ref, wv_ref, n_ref = ck.compact_live_rows_plain(w)
    live = int(n_live.item())
    if (live != int(n_ref.item()) or not torch.equal(idx[:live], idx_ref[:live])
            or not torch.equal(wv[:live], wv_ref[:live])):
        raise RuntimeError(f"compaction differs from torch.nonzero: L={live} vs {int(n_ref.item())}")
    return (idx, wv, n_live), live


def kernel_phase(torch, ck):
    """Each kernel against its plain version under three weight patterns at
    the VOC table, and under the thinned one at the Cityscapes table, then
    timed; the rows kept for the JSON line are the ``thinned`` ones, what the
    main paths feed the kernels.  Every class's compaction at VOC's 21
    classes and Cityscapes' 19, thinned (the JSON row) and as
    ``expected_pallas`` feeds it (dense weights, no uniforms)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = _l2_flush(torch)
    voc = _kernel_shape(torch, ck, g, flush, N_VOC, ("dead_half", "thinned", "scattered"))
    city = _kernel_shape(torch, ck, g, flush, N_CITY, ("thinned",))
    for out, c, n in ((voc, 21, N_VOC), (city, 19, N_CITY)):
        p_over_cnt, cls, u = _class_inputs(torch, g, c, n)
        out["class"] = _class_rows_row(torch, ck, flush, p_over_cnt, cls, NUM_NEGATIVES, u,
                                       f"C={c} N={n} thinned")
        out["class"]["expected_mode"] = _class_rows_row(
            torch, ck, flush, p_over_cnt, cls, NUM_NEGATIVES, None, f"C={c} N={n} expected")
        del p_over_cnt, cls, u
    return voc, city


def _kernel_shape(torch, ck, g, flush, n: int, kinds):
    results = {k: {"max_abs_err": 0.0} for k in ("k1", "k2", "compact")}
    for kind in kinds:
        a, r, w = _kernel_inputs(torch, ck, g, kind, n)
        comp, live = _check_compaction(torch, ck, w)
        s = ck.softsum_kernel(a, r, w, INV_TEMP)
        m = ck.softsum_moment_kernel(a, r, w, INV_TEMP)
        torch.cuda.synchronize()
        s_ref = ck.softsum_plain(a, r, w, INV_TEMP)
        m_ref = ck.softsum_moment_plain(a, r, w, INV_TEMP)
        torch.testing.assert_close(s, s_ref, rtol=K1_RTOL, atol=1e-6)
        m_scale = m_ref.abs().max().item()
        torch.testing.assert_close(m, m_ref, rtol=K2_RTOL, atol=K2_ATOL_FRACTION * m_scale)
        errs = {"k1": (s - s_ref).abs().max().item(), "k2": (m - m_ref).abs().max().item(),
                "compact": 0.0}   # checked equal above
        bounds = _bounds_ms(a, w, live)
        matmul_ms, _ = _timed(torch, lambda: torch.matmul(a, r.T), 10, flush)
        timing = {   # (kernel wrapper, plain version, library call)
            "k1": (lambda: ck.softsum_kernel(a, r, w, INV_TEMP),
                   lambda: ck.softsum_plain(a, r, w, INV_TEMP), None),
            "k2": (lambda: ck.softsum_moment_kernel(a, r, w, INV_TEMP),
                   lambda: ck.softsum_moment_plain(a, r, w, INV_TEMP), None),
            "compact": (lambda: ck.compact_live_rows_kernel(w),
                        lambda: ck.compact_live_rows_plain(w), lambda: torch.nonzero(w)),
        }
        for name, (kern, plain, library) in timing.items():
            ms, device_ms = _timed(torch, kern, 20, flush, COMPACT_KERNEL)
            library_ms = _timed(torch, library, 10, flush)[0] if library else matmul_ms
            row = dict(ms=ms, device_ms=device_ms,
                       plain_ms=_timed(torch, plain, 5, flush)[0],
                       bound_ms=bounds[name][0], bound_by=bounds[name][1],
                       library_ms=library_ms, max_abs_err=errs[name])
            print(f"kernel {name} N={n} w={kind} live_rows={live}: " + json.dumps(row),
                  flush=True)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], errs[name])
            if kind == "thinned":     # what the main path feeds the kernels
                results[name].update({k: v for k, v in row.items() if k != "max_abs_err"})
        # K1 and K2 alone over a saved compaction, as the step's backward runs K2
        for name, kern in (("k1", ck.softsum_live_kernel), ("k2", ck.softsum_moment_live_kernel)):
            ms, device_ms = _timed(torch, lambda: kern(a, r, *comp, INV_TEMP), 20, flush,
                                   f"{name}_live")
            print(f"kernel {name}_over_compaction N={n} w={kind} live_rows={live}: "
                  + json.dumps(dict(ms=ms, device_ms=device_ms)), flush=True)
        del a, r, w, s, m, s_ref, m_ref, comp
        torch.cuda.empty_cache()
    return results


def _bn_eager(torch, bn, groups: int, residual: bool, relu: bool, library: bool):
    """The whole BN as autograd runs it without the kernels: the module's
    own code, or ATen's ``F.batch_norm`` a group (the yardstick)."""
    import torch.nn.functional as F

    def fn(x, res):
        if library:
            rm, rv = bn.running_mean.clone(), bn.running_var.clone()
            y = torch.cat([F.batch_norm(h, rm, rv, bn.weight, bn.bias, True, 0.1, bn.eps)
                           for h in x.chunk(groups)])
        else:
            y = bn._normalize(x, groups)
        if res is not None:
            y = y + res
        return F.relu(y) if relu else y
    return fn


def batchnorm_phase(torch) -> list:
    """The BatchNorm kernels at ``BN_SHAPES``: checked against their plain
    versions, timed beside them and their bounds; the whole BN three ways."""
    import dataclasses

    from css_tpu_torch.models.resnet import GroupedBatchNorm
    from css_tpu_torch.ops.kernels import batchnorm_kernels as bk

    flush = _l2_flush(torch)
    rows = []
    for label, shape, groups, residual, relu in BN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)

        def make(scale=1.0, shift=0.0):
            t = torch.randn(shape, generator=g, device="cuda") * scale + shift
            return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x, dy = make(1.5, 0.3), make()
        res = make() if residual else None
        bn = GroupedBatchNorm(shape[1]).cuda()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.5, 0.5, generator=g)
            bn.running_mean.uniform_(-1.0, 1.0, generator=g)
            bn.running_var.uniform_(0.5, 1.5, generator=g)
        w, b = bn.weight.detach(), bn.bias.detach()
        n = x.numel() // shape[1] // groups
        fin = bk.Finish(n, bn.eps, bn.momentum, False, bn.running_mean, bn.running_var)

        def moving():   # a Finish that moves copies of the running stats
            return dataclasses.replace(fin, update=True, running_mean=bn.running_mean.clone(),
                                       running_var=bn.running_var.clone())
        moved = {way: (moving(), moving()) for way in ("kernel", "plain")}
        sums_x, stat = bk.stats_kernel(x, groups, moved["kernel"][0])
        stat_plain = bk.stats_plain(x, groups, moved["plain"][0])[1]
        stat_finish = bk.finish_kernel(sums_x, moved["kernel"][1])
        finish_plain = bk.finish_plain(sums_x, moved["plain"][1])
        y = bk.apply_kernel(x, stat, w, b, groups, res, relu)
        saved = y if relu else None
        sums, dw, _ = bk.grad_stats_kernel(x, dy, saved, stat, groups)
        dx, _ = bk.grad_apply_kernel(x, dy, saved, stat, w, sums, n, groups, residual)
        torch.cuda.synchronize()
        gaps = {   # each kernel's output against its plain version's, on the same inputs
            "stat": (stat, stat_plain),
            "finish_stat": (stat_finish, finish_plain),
            "y": (y, bk.apply_plain(x, stat, w, b, groups, res, relu)),
            "grad_sums": (sums, bk.grad_stats_plain(x, dy, saved, stat, groups)[0]),
            "dx": (dx, bk.grad_apply_plain(x, dy, saved, stat, w, sums, n, groups, residual)[0]),
        }
        # the running stats each kernel moved (momentum, group 0 first, Bessel)
        for i, kind in enumerate(("stats", "finish")):
            k_fin, p_fin = moved["kernel"][i], moved["plain"][i]
            gaps[f"{kind}_running_mean"] = (k_fin.running_mean, p_fin.running_mean)
            gaps[f"{kind}_running_var"] = (k_fin.running_var, p_fin.running_var)
        gaps = {k: ((a.double() - p.double()).norm() / p.double().norm()).item()
                for k, (a, p) in gaps.items()}
        if max(gaps["y"], gaps["dx"]) > 2.0 ** -8 or max(
                v for k, v in gaps.items() if k not in ("y", "dx")) > 1e-4:
            raise RuntimeError(f"batchnorm {label}: kernels against plain {gaps}")
        pass_bytes = 2 * x.numel()          # one bf16 pass over [M, C]
        kernels = {   # (kernel, plain version, least bytes: inputs read once, outputs written)
            "css_bn_stats": (lambda: bk.stats_kernel(x, groups, fin),
                             lambda: bk.stats_plain(x, groups, fin), 1),
            "css_bn_apply": (lambda: bk.apply_kernel(x, stat, w, b, groups, res, relu),
                             lambda: bk.apply_plain(x, stat, w, b, groups, res, relu),
                             2 + residual),
            "css_bn_grad_stats": (lambda: bk.grad_stats_kernel(x, dy, saved, stat, groups),
                                  lambda: bk.grad_stats_plain(x, dy, saved, stat, groups),
                                  2 + relu),
            "css_bn_grad_apply": (
                lambda: bk.grad_apply_kernel(x, dy, saved, stat, w, sums, n, groups, residual),
                lambda: bk.grad_apply_plain(x, dy, saved, stat, w, sums, n, groups, residual),
                3 + relu + residual),
        }
        row = dict(label=label, shape=list(shape), groups=groups, residual=residual,
                   relu=relu, gaps=gaps)
        for name, (kern, plain, passes) in kernels.items():
            ms, device_ms = _timed(torch, kern, 20, flush, name)
            row[name] = dict(ms=ms, device_ms=device_ms,
                             bound_ms=passes * pass_bytes / HBM_BYTES_PER_S * 1e3,
                             plain_ms=_timed(torch, plain, 5, flush)[0])
        # the whole BN, forward and forward + backward, the kernels and two eager ways
        ways = {"kernels": lambda xi, ri: bn.fused_train(xi, groups, ri, relu),
                "module": _bn_eager(torch, bn, groups, residual, relu, library=False),
                "library": _bn_eager(torch, bn, groups, residual, relu, library=True)}
        xg = x.detach().requires_grad_(True)
        rg = None if res is None else res.detach().requires_grad_(True)
        wrt = [xg, bn.weight, bn.bias] + ([rg] if residual else [])
        for way, fn in ways.items():
            row[way] = dict(
                forward_ms=_timed(torch, lambda: fn(x, res), 10, flush)[0],
                forward_backward_ms=_timed(
                    torch, lambda: torch.autograd.grad(fn(xg, rg), wrt, dy), 10, flush)[0])
        print(f"batchnorm {label}: " + json.dumps(row), flush=True)
        rows.append(row)
        del x, dy, res, y, saved, sums, dw, dx, stat, xg, rg, sums_x, moved, stat_plain, \
            stat_finish, finish_plain
        torch.cuda.empty_cache()
    return rows


def contrastive_phase(torch, ck):
    """The contrastive loss on the card (K1/K2) against the CPU (plain) at a
    small input; then one full-size VOC loss through ``class_live_rows``
    against the same loss on the per-class path it replaced, bit for bit."""
    from css_tpu_torch.losses.contrastive import prototype_contrastive_loss

    g = torch.Generator().manual_seed(1)
    b, h, w, c, q = 4, 16, 16, 21, 256
    n = b * h * w
    rep = torch.randn(b, h, w, D, generator=g)
    lab = torch.randint(0, c, (b, h, w), generator=g)
    onehot = torch.nn.functional.one_hot(lab, c).float()
    mask = (torch.rand(b, h, w, generator=g) < 0.8).float()
    prob = torch.softmax(3 * torch.randn(b, h, w, c, generator=g), dim=-1)
    protos = torch.randn(c, D, generator=g)
    draws = dict(tie=torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32),
                 u1=torch.rand(c, q, generator=g), u=torch.rand(c, n, generator=g))
    out = {}
    for dev in ("cpu", "cuda"):
        x = rep.to(dev).detach().requires_grad_(True)
        loss, new_protos = prototype_contrastive_loss(
            x, onehot.to(dev), mask.to(dev), prob.to(dev), protos.to(dev),
            **{k: v.to(dev) for k, v in draws.items()}, num_negatives=NUM_NEGATIVES)
        loss.backward()
        out[dev] = (loss.detach().cpu(), new_protos.cpu(), x.grad.cpu())
    torch.cuda.synchronize()
    # bf16 operands in both; sums in another order, K2's bf16 exp
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-5)
    g_scale = out["cpu"][2].abs().max().item()
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=2e-2, atol=1e-2 * g_scale)
    print(f"contrastive: loss cuda {out['cuda'][0].item():.6f} cpu {out['cpu'][0].item():.6f}",
          flush=True)
    _full_size_loss_check(torch, ck)


def _full_size_loss_check(torch, ck):
    """A VOC loss at full size (16 x 128^2 = 262,144 table rows, 21 classes,
    Q = 256, G = 512, D = 256, ``sampled_pallas``): loss, new prototypes and
    the gradient on ``rep`` through ``class_live_rows`` bit-equal to the
    per-class path (``_PerClassPath``); each path's launches."""
    from css_tpu_torch.losses.contrastive import prototype_contrastive_loss

    g = torch.Generator(device="cuda").manual_seed(2)
    b, h, w, c, q = 16, 128, 128, 21, 256
    n = b * h * w
    dev = "cuda"
    inputs = (torch.randn(b, h, w, D, device=dev, generator=g),
              torch.nn.functional.one_hot(
                  torch.randint(0, c, (b, h, w), device=dev, generator=g), c).float(),
              (torch.rand(b, h, w, device=dev, generator=g) < 0.8).float(),
              torch.softmax(3 * torch.randn(b, h, w, c, device=dev, generator=g), dim=-1),
              torch.randn(c, D, device=dev, generator=g))
    draws = dict(tie=torch.randint(0, 1 << 24, (n,), device=dev, generator=g, dtype=torch.int32),
                 u1=torch.rand(c, q, device=dev, generator=g),
                 u=torch.rand(c, n, device=dev, generator=g))
    out = {}
    for path in ("batched", "per_class"):
        x = inputs[0].detach().requires_grad_(True)
        ck.reset_launches()
        with _PerClassPath() if path == "per_class" else contextlib.nullcontext():
            loss, protos = prototype_contrastive_loss(x, *inputs[1:], **draws,
                                                      num_negatives=NUM_NEGATIVES)
            loss.backward()
        torch.cuda.synchronize()
        out[path] = (loss.detach(), protos, x.grad, dict(ck.LAUNCHES))
    _check_launches("contrastive full-size loss", out["batched"][3], 1, c)
    want = dict(_want_launches(0, c), live_rows_compact=c, weighted_exp_softsum_fwd=c,
                weighted_exp_softsum_bwd=c)
    if out["per_class"][3] != want:
        raise RuntimeError(f"contrastive per-class path: launches {out['per_class'][3]}, "
                           f"want {want}")
    same = [torch.equal(x, y) for x, y in zip(out["batched"][:3], out["per_class"][:3])]
    print(f"contrastive full size (N={n}, C={c}): loss {out['batched'][0].item():.9f} through "
          f"class_live_rows, {out['per_class'][0].item():.9f} per class; loss, prototypes, "
          f"gradient bit-equal {same}; launches {json.dumps(out['batched'][3])} vs per class "
          f"{json.dumps(out['per_class'][3])}", flush=True)
    if not all(same) or not math.isfinite(out["batched"][0].item()):
        raise RuntimeError(f"contrastive full size: the batched path differs from the "
                           f"per-class path (loss, prototypes, gradient equal: {same})")


def _check_finite(losses, label: str):
    for i, m in enumerate(losses):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{label}: non-finite losses at timed step {i}: {bad}")


def _timed_steps(torch, ck, one_step, warmup: int, steps: int, c: int, label: str,
                 graphed: bool = False):
    """``warmup`` untimed steps, then ``steps`` timed ones, with the launch
    counters zeroed before the warm-up and the peak reset after its first
    step (the key's eager call, which carries cuDNN's autotune; the capture
    follows it), so that both hold the capture; fails on a non-finite loss, launches other
    than one contrastive loss over ``c`` classes a step whose Python ran
    (``_want_launches``; ``c`` 0: a path that runs no kernel), a train-mode
    BN that missed the BatchNorm kernels (``_BnCalls``), or, with
    ``graphed``, a timed step that did not replay CUDA graphs.  Returns (ms
    per step, peak GiB, contrastive launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    replays = REPLAYS[0]
    losses, times = [], []
    with _BnCalls(torch) as bn_calls:
        for i in range(warmup):
            one_step()
            if i == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        timed = REPLAYS[0]
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(one_step())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    bn_calls.check(label)
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    replayed, timed = REPLAYS[0] - replays, REPLAYS[0] - timed
    losses = [{k: v.item() for k, v in m.items()} for m in losses]
    for i, m in enumerate(losses):
        print(f"{label} step {i}: {times[i] * 1e3:.3f} ms " + json.dumps(m), flush=True)
    _check_finite(losses, label)
    python = warmup + steps - replayed
    _check_launches(f"{label} ({warmup + steps} steps, {replayed} replayed)", launches,
                    python if c else 0, c)
    if graphed and timed != steps:
        raise RuntimeError(f"{label}: {timed} of the {steps} timed steps replayed CUDA graphs")
    ms = sum(times) / steps * 1e3
    print(f"{label}: {ms:.3f} ms/step (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; "
          f"{timed} of {steps} replayed), peak memory {peak:.3f} GiB, launches "
          f"{json.dumps(launches)} in {python} steps that ran their Python", flush=True)
    return ms, peak, launches


def _class_path_pairs(torch, ck, one_step, steps: int, c: int, label: str):
    """The step through ``class_live_rows`` and on the per-class path it
    replaced (``_PerClassPath``), ``steps`` timed steps a block, in turns:
    batched, per-class, per-class, batched, twice, every step eager (a
    replay would not see the patch); each block's launches checked.  Prints
    each block's ms/step and the ratio of the sums."""
    ms = {"batched": [], "per_class": []}
    for path in ("batched", "per_class", "per_class", "batched") * 2:
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        with _PerClassPath() if path == "per_class" else contextlib.nullcontext(), \
                _eager_steps():
            for _ in range(steps):
                _check_finite([{k: v.item() for k, v in one_step().items()}],
                              f"{label} {path}")
            torch.cuda.synchronize()
        ms[path].append((time.perf_counter() - t0) / steps * 1e3)
        launches = dict(ck.LAUNCHES)
        want = _want_launches(steps, c)
        if path == "per_class":
            want.update(class_live_rows=0, live_rows_compact=c * steps)
        if launches != want:
            raise RuntimeError(f"{label} {path}: launches {launches}, want {want}")
    ratio = sum(ms["batched"]) / sum(ms["per_class"])
    print(f"{label} class_live_rows vs per-class path, {steps} steps a block in turns "
          f"(batched, per-class, per-class, batched, twice): batched {json.dumps(ms['batched'])} "
          f"ms/step, per-class {json.dumps(ms['per_class'])} ms/step; batched / per-class "
          f"{ratio:.4f}", flush=True)
    return ratio


def _graph_vs_eager(torch, label: str, state, make_step, batch: dict, make_draws) -> None:
    """The replayed step against the eager one at full size: copies of
    ``state`` take three steps on ``batch`` with the same draws (the list
    ``make_draws()`` returns, made anew for each copy from the same seed),
    each through a new step function (``make_step()``): one as it runs (its
    first call eager, the next a capture, replays after), two with every
    step eager; all under deterministic algorithms and cuDNN's deterministic
    picks.  Where the two eager runs agree bit for bit (the card repeats
    itself), the replayed run must equal them bit for bit in the losses, both
    networks' parameters and buffers, the momentum and the prototypes; where
    they do not, its largest gap from the first must stay within four times
    theirs.  It must replay at least once."""
    import copy

    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs, replayed = {}, 0
    try:
        for name in ("replayed", "eager", "eager again"):
            st, step = copy.deepcopy(state), make_step()
            replays = REPLAYS[0]
            losses = []
            draws = make_draws()
            with _eager_steps() if name != "replayed" else contextlib.nullcontext():
                for d in draws:
                    metrics = step(st, batch, d, 1.0)[1]
                    losses.append(torch.stack([metrics[k] for k in sorted(metrics)]).float().cpu())
            if name == "replayed":
                replayed = REPLAYS[0] - replays
            runs[name] = _host_state(st) + losses
            del st, step
            _free(torch)
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]

    def gap(a, b) -> float:
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    graph_gap, eager_gap = gap(runs["replayed"], runs["eager"]), gap(runs["eager again"],
                                                                     runs["eager"])
    equal = all(torch.equal(x, y) for x, y in zip(runs["replayed"], runs["eager"]))
    print(f"{label} replayed vs eager, {len(draws)} steps from one state ({replayed} replayed; "
          f"{len(runs['eager'])} tensors: losses, student, teacher, momentum, prototypes): "
          f"bit-equal {equal}, largest gap {graph_gap:.6g}; eager vs eager again: largest gap "
          f"{eager_gap:.6g}", flush=True)
    if replayed < 1:
        raise RuntimeError(f"{label}: the graph run replayed no step")
    if not all(math.isfinite(float(t.abs().max())) for t in runs["replayed"][-len(draws):]):
        raise RuntimeError(f"{label}: non-finite losses in the replayed run")
    if (eager_gap == 0 and not equal) or graph_gap > 4 * eager_gap:
        raise RuntimeError(f"{label}: the replayed steps differ from the eager ones by "
                           f"{graph_gap:.6g} (two eager runs: {eager_gap:.6g})")


def _seeded_draws(torch, cfg, bsz: int, rows: int, n: int = 3) -> list:
    """``n`` steps' draws from one fixed seed."""
    from css_tpu_torch.train.draws import sample_step_draws

    g = torch.Generator(device="cuda").manual_seed(11)
    return [sample_step_draws(g, cfg, bsz, bsz, rows) for _ in range(n)]


def _voc_batch(torch, bsz: int, crop: int, c: int):
    """The train phase's synthetic VOC batch, on the card."""
    g_cpu = torch.Generator().manual_seed(0)
    batch = {
        "l_image": torch.rand(bsz, crop, crop, 3, generator=g_cpu),
        "l_label": torch.randint(0, c, (bsz, crop, crop), generator=g_cpu, dtype=torch.int32),
        "l_valid_hw": torch.full((bsz, 2), crop, dtype=torch.int32),
        "u_image": torch.rand(bsz, crop, crop, 3, generator=g_cpu),
        "u_valid_hw": torch.full((bsz, 2), crop, dtype=torch.int32),
    }
    return {k: v.cuda() for k, v in batch.items()}


def train_phase(torch, ck, steps: int):
    from css_tpu_torch.models.deeplabv3 import build_model
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.state import create_train_state
    from css_tpu_torch.train.train_step import StepConfig, make_train_step

    c, crop, bsz = 21, 512, 8
    cfg = StepConfig(num_classes=c, crop_hw=(crop, crop), scale_range=(0.5, 1.5))
    model = build_model(c, 256, "resnet101", dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, c, 256, base_lr=6.4e-3, weight_decay=5e-4,
                               total_steps=80_000, device="cuda")
    step = make_train_step(cfg)
    batch = _voc_batch(torch, bsz, crop, c)
    g = torch.Generator(device="cuda").manual_seed(1)
    h, w = state.model.output_hw(cfg.crop_hw)

    def one_step():
        draws = sample_step_draws(g, cfg, bsz, bsz, 2 * bsz * h * w)
        _, metrics = step(state, batch, draws, 1.0)
        return metrics

    ms, peak_gib, launches = _timed_steps(torch, ck, one_step, 2, steps, c, "train",
                                          graphed=True)
    if peak_gib > PEAK_GIB_LIMIT:
        raise RuntimeError(f"peak memory {peak_gib:.3f} GiB exceeds {PEAK_GIB_LIMIT} GiB")
    print(f"train: {2 * bsz * 1e3 / ms:.3f} img/s", flush=True)
    del step
    _graph_vs_eager(torch, "train", state, lambda: make_train_step(cfg), batch,
                    lambda: _seeded_draws(torch, cfg, bsz, 2 * bsz * h * w))
    step = make_train_step(cfg)
    _class_path_pairs(torch, ck, one_step, steps, c, "train")
    return launches, dict(state=state, batch=batch, g=g, ms=ms)


def strategies_phase(torch, ck, train, steps: int):
    """Full-size ``mix`` and ``cross`` steps, continuing the train phase's
    state (its prototypes are real), with the thresholds of their entry
    points; then a ``cross`` run through its entry point that switches to
    the representation-space labels inside the run."""
    from css_tpu_torch.train import train_step as ts
    from css_tpu_torch.train.draws import sample_step_draws

    state, batch, g = train["state"], train["batch"], train["g"]
    c, crop, bsz = 21, 512, 8
    h, w = state.model.output_hw((crop, crop))
    kept = []
    real_mix = ts.mix_batch

    def recording_mix(img, labels, confs, **kw):
        # before mixing: padding has confidence 0, a disagreement label -1;
        # in eager steps only (a capture's tensors hold no values)
        if not torch.cuda.is_current_stream_capturing():
            valid = confs[:, 0] > 0
            kept.append(torch.stack([(valid & (labels[:, 0] >= 0)).sum(), valid.sum()]))
        return real_mix(img, labels, confs, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = {}
    for strategy in ("mix", "cross"):
        cfg = ts.StepConfig(num_classes=c, crop_hw=(crop, crop), scale_range=(0.5, 1.5),
                            strategy=strategy, strong_threshold=0.8, weak_threshold=0.7,
                            un_threshold=0.97, rep_temp=0.5)
        step = ts.make_train_step(cfg)

        def one_step(use_rep):
            draws = sample_step_draws(g, cfg, bsz, bsz, 2 * bsz * h * w)
            return step(state, batch, draws, 1.0, use_rep)[1]

        torch.cuda.synchronize()
        ck.reset_launches()
        kept.clear()
        ts.mix_batch = recording_mix
        losses, times = [], []
        replays = REPLAYS[0]
        try:
            with _BnCalls(torch) as bn_calls:
                one_step(False)               # warm-up; cross still on logit labels
                torch.cuda.synchronize()
                for _ in range(steps):
                    t0 = time.perf_counter()
                    losses.append(one_step(strategy == "cross"))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
        finally:
            ts.mix_batch = real_mix
        bn_calls.check(strategy)
        launches = dict(ck.LAUNCHES)
        replayed = REPLAYS[0] - replays
        losses = [{k: v.item() for k, v in m.items()} for m in losses]
        for i, m in enumerate(losses):
            print(f"{strategy} step {i}: {times[i] * 1e3:.3f} ms " + json.dumps(m), flush=True)
        _check_finite(losses, strategy)
        _check_launches(f"{strategy} ({1 + steps} steps, {replayed} replayed)", launches,
                        1 + steps - replayed, c)
        ms[strategy] = sum(times) / steps * 1e3
        share = torch.stack(kept).sum(0).tolist()
        print(f"{strategy}: {ms[strategy]:.3f} ms/step (min {min(times) * 1e3:.3f}, max "
              f"{max(times) * 1e3:.3f}) vs ori {train['ms']:.3f} ms/step in this run "
              f"({ms[strategy] / train['ms']:.4f}x; {replayed} steps replayed); unlabeled "
              f"pixels with a label / valid in the eager steps {share[0]}/{share[1]} = "
              f"{share[0] / share[1]:.4f}; launches {json.dumps(launches)}", flush=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if peak_gib > STRATEGIES_PEAK_GIB_LIMIT:
        raise RuntimeError(f"strategies: peak memory {peak_gib:.3f} GiB exceeds "
                           f"{STRATEGIES_PEAK_GIB_LIMIT} GiB")
    print(f"strategies: peak memory {peak_gib:.3f} GiB (limit {STRATEGIES_PEAK_GIB_LIMIT})",
          flush=True)


def cross_entry_phase(torch, ck):
    """``cross`` through its entry point: 2 epochs of 2 steps, ``--warmup
    1``, an eval after each epoch, in a temporary directory."""
    import gc
    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.config import CONFIG_DIR
    from css_tpu_torch.train.schedulers import rampdown_value

    gc.collect()
    torch.cuda.empty_cache()
    args = entries.cross_label_parser().parse_args(
        ["--config", os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"), "--synthetic",
         "--num_labels", "16", "--total_iter", "4", "--warmup", "1", "--job_name", "smoke"])
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cross_")
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        with _DriverProbe(torch, train_main) as probe:
            ck.reset_launches()
            replays = REPLAYS[0]
            t0 = time.perf_counter()
            result = train_main.run_training("cross", args)
            seconds = time.perf_counter() - t0
            launches = dict(ck.LAUNCHES)
            replayed = REPLAYS[0] - replays
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    losses = [{k: v.item() for k, v in m.items()} for m in probe.losses]
    _check_finite(losses, "cross entry point")
    flags = [(weight, use_rep) for weight, use_rep in probe.step_args]
    ramp = [rampdown_value(e, 0, 200, 1.0, 0.0, -5.0) for e in (0, 0, 1, 1)]
    if result["steps"] != 4 or flags != list(zip(ramp, (False, False, True, True))):
        raise RuntimeError(f"cross entry point: {result['steps']} steps, (weight, use_rep) "
                           f"{flags}, want {list(zip(ramp, (False, False, True, True)))}")
    if len(probe.evals) != 2:
        raise RuntimeError(f"cross entry point: {len(probe.evals)} evals, want 2")
    _check_launches(f"cross entry point (4 steps, {replayed} replayed)", launches, 4 - replayed)
    for i, m in enumerate(losses):
        print(f"cross entry step {i + 1} (weight {flags[i][0]:.6f}, rep labels "
              f"{flags[i][1]}): " + json.dumps(m), flush=True)
    print(f"cross entry point: {seconds:.3f} s wall, {json.dumps(result)}, device-timeline ms "
          f"between step ends {json.dumps(probe.step_ms())}, launches {json.dumps(launches)}",
          flush=True)


class _DriverProbe:
    """Wraps the driver's step, eval and checkpoint functions (module
    attributes of ``css_tpu_torch.cli.train_main``) to observe one run:
    each step's losses and device end time, the state the first step
    receives, each eval batch's matrix update beside its count of valid
    label pixels, and eval and checkpoint times."""

    NAMES = ("make_train_step", "make_eval_step", "_evaluate", "save_checkpoint")

    def __init__(self, torch, train_main):
        self.torch, self.module = torch, train_main
        self.orig = {name: getattr(train_main, name) for name in self.NAMES}
        self.losses, self.evals, self.saves, self.step_args = [], [], [], []
        self.new_run()

    def new_run(self):
        self.start, self.step_ends, self.step_at, self.counts = None, [], [], []

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.module, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)

    def make_train_step(self, cfg):
        step = self.orig["make_train_step"](cfg)

        def probed(state, batch, draws, *args):
            if self.start is None:
                self.start = (state.step, state.prototypes.clone())
            self.step_at.append(time.perf_counter())
            self.step_args.append(args)
            state, metrics = step(state, batch, draws, *args)
            self.losses.append(metrics)
            end = self.torch.cuda.Event(enable_timing=True)
            end.record()
            self.step_ends.append(end)
            return state, metrics
        return probed

    def make_eval_step(self, model, num_classes, **kw):
        eval_step = self.orig["make_eval_step"](model, num_classes, **kw)

        def probed(conf_mat, image, label, valid):
            out = eval_step(conf_mat, image, label, valid)
            ok = (label >= 0) & (label < num_classes) & valid[:, None, None]
            self.counts.append(((out - conf_mat).sum(), ok.sum(), valid.sum()))
            return out
        return probed

    def _evaluate(self, *args, **kw):
        """Over more than one rank the matrix holds every rank's shard: its
        total is checked by the caller against the ranks' pixel counts."""
        self.torch.cuda.synchronize()
        first = len(self.counts)
        t0 = time.perf_counter()
        cm = self.orig["_evaluate"](*args, **kw)
        seconds = time.perf_counter() - t0
        counts = [[int(x) for x in c] for c in self.counts[first:]]
        total, pixels, images = (sum(c[i] for c in counts) for i in range(3))
        sharded = self.torch.distributed.is_initialized()
        if total != pixels or (int(cm.mat.sum()) != pixels and not sharded):
            raise RuntimeError(f"eval: confusion-matrix total {int(cm.mat.sum())} (batch deltas "
                               f"{total}) vs {pixels} valid label pixels in the crops")
        self.evals.append(dict(seconds=seconds, images=images, pixels=pixels, miou=cm.miou,
                               total=int(cm.mat.sum())))
        return cm

    def save_checkpoint(self, path, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.orig["save_checkpoint"](path, *args, **kw)
        self.saves.append((os.path.basename(path), time.perf_counter() - t0,
                           os.path.getsize(path)))

    def step_ms(self):
        """Device-timeline ms between consecutive step ends of this run,
        the first interval left out, as the driver's StepTimer does."""
        self.torch.cuda.synchronize()
        ends = self.step_ends
        return [a.elapsed_time(b) for a, b in zip(ends[1:], ends[2:])]


def _loader_ms_per_batch(batches: int = 6) -> float:
    """Host ms per batch of the driver's loader at the driver phase's shapes,
    with nothing else running: the decode rate the train loop can draw on."""
    from css_tpu_torch.data import BatchLoader, SyntheticSpec

    loader = BatchLoader(SyntheticSpec(num_classes=21, canvas_hw=(512, 512)),
                         [f"l{i}" for i in range(8 * batches)], 8, seed=3407)
    try:
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        return (time.perf_counter() - t0) * 1e3 / n
    finally:
        loader.close()


def driver_phase(torch, ck, smi: str, keep_checkpoint: str):
    """Runs A (4 steps + eval) and B (resumed, steps 5-6 + eval) through the
    port's entry point and checks them; see the module docstring.  Run B's
    ``last_model`` is copied to ``keep_checkpoint`` for the opt-in phase."""
    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.config import CONFIG_DIR

    _free(torch)
    common = ["--config", os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"), "--synthetic",
              "--job_name", "smoke", "--num_labels", "32"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    cwd = os.getcwd()
    results, ms = {}, {}
    try:
        os.chdir(workdir)   # the YAML's save_dir, ./checkpoints/, lands here
        last = os.path.join(workdir, "checkpoints", "smoke", "last_model")
        with _DriverProbe(torch, train_main) as probe:
            ck.reset_launches()
            replays = REPLAYS[0]
            for run, extra in (("A", ["--total_iter", "4", "--max_steps", "4"]),
                               ("B", ["--resume", last, "--total_iter", "8", "--max_steps", "6"])):
                if run == "B":
                    saved = torch.load(last, map_location="cpu", weights_only=True)
                probe.new_run()
                t0 = time.perf_counter()
                results[run] = train_main.run_training(
                    "ori", entries.ori_pseudo_parser().parse_args(common + extra))
                print(f"driver run {run}: {time.perf_counter() - t0:.3f} s wall, "
                      f"{json.dumps(results[run])}", flush=True)
                ms[run] = probe.step_ms()
                if run == "B":
                    start_step, start_protos = probe.start
            launches = dict(ck.LAUNCHES)
            replayed = REPLAYS[0] - replays
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        shutil.copy(last, keep_checkpoint)
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)

    losses = [{k: v.item() for k, v in m.items()} for m in probe.losses]
    bad = [i for i, m in enumerate(losses) if not all(math.isfinite(v) for v in m.values())]
    if len(losses) != 6 or bad:
        raise RuntimeError(f"driver: {len(losses)} steps logged, non-finite losses at {bad}")
    if results["A"]["steps"] != 4 or saved["step"] != 4 or start_step != 4:
        raise RuntimeError(f"driver: run A ended at step {results['A']['steps']}, saved step "
                           f"{saved['step']}, run B started at step {start_step}")
    if results["B"]["steps"] != 6:
        raise RuntimeError(f"driver: run B ended at step {results['B']['steps']}, want 6")
    if not torch.equal(start_protos.cpu(), saved["prototypes"]):
        raise RuntimeError("driver: run B did not start from the prototypes run A saved")
    if len(probe.evals) != 2:
        raise RuntimeError(f"driver: {len(probe.evals)} evals, want one per run")
    _check_launches(f"driver (both runs, 6 steps, {replayed} replayed)", launches, 6 - replayed)

    sps = results["A"]["steps_per_sec"]
    for i, m in enumerate(losses):
        print(f"driver step {i + 1}: " + json.dumps(m), flush=True)
    for i, e in enumerate(probe.evals):
        print(f"driver eval {'AB'[i]}: {e['seconds'] * 1e3 / e['images']:.3f} ms/image over "
              f"{e['images']} images ({e['seconds']:.3f} s), {e['pixels']} valid label pixels "
              f"counted, mIoU {e['miou']:.6f}", flush=True)
    for name, seconds, size in probe.saves:
        print(f"driver checkpoint {name}: {seconds:.3f} s, {size / 2**30:.3f} GiB", flush=True)
    loader_ms = _loader_ms_per_batch()
    print(f"driver loader alone: {loader_ms:.3f} ms per batch of 8 synthetic 512x512 images "
          f"(8 decode threads, nothing else running); a step takes 2 batches", flush=True)
    print(f"driver ({smi}): steps/s {sps:.4f} = {1e3 / sps:.3f} ms/step (driver StepTimer, "
          f"run A); device-timeline ms between step ends {json.dumps(ms)}; "
          f"peak memory {peak_gib:.3f} GiB; launches {json.dumps(launches)}", flush=True)


def _record_calls(module, name: str, calls: list):
    """Wraps ``module.name`` so that each call's arguments are appended to
    ``calls``; returns a function that puts the original back."""
    real = getattr(module, name)

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    setattr(module, name, recording)
    return lambda: setattr(module, name, real)


def _dense_kernel_row(torch, ck, a, r, w, inv_temp: float) -> dict:
    """K1, K2 and the compaction on one class's dense weights from the
    ``expected_pallas`` step: against their plain versions, then timed with
    the L2 flushed before each call, as the kernel phase does."""
    flush = _l2_flush(torch)
    comp, live = _check_compaction(torch, ck, w)
    s, m = ck.softsum_kernel(a, r, w, inv_temp), ck.softsum_moment_kernel(a, r, w, inv_temp)
    s_ref, m_ref = ck.softsum_plain(a, r, w, inv_temp), ck.softsum_moment_plain(a, r, w, inv_temp)
    torch.testing.assert_close(s, s_ref, rtol=K1_RTOL, atol=1e-6)
    torch.testing.assert_close(m, m_ref, rtol=K2_RTOL,
                               atol=K2_ATOL_FRACTION * m_ref.abs().max().item())
    errs = {"k1": (s - s_ref).abs().max().item(), "k2": (m - m_ref).abs().max().item(),
            "compact": 0.0}
    bounds = _bounds_ms(a, w, live)
    matmul_ms = _timed(torch, lambda: torch.matmul(a, r.T), 10, flush)[0]
    timing = {"k1": (lambda: ck.softsum_kernel(a, r, w, inv_temp),
                     lambda: ck.softsum_plain(a, r, w, inv_temp), None),
              "k2": (lambda: ck.softsum_moment_kernel(a, r, w, inv_temp),
                     lambda: ck.softsum_moment_plain(a, r, w, inv_temp), None),
              "compact": (lambda: ck.compact_live_rows_kernel(w),
                          lambda: ck.compact_live_rows_plain(w), lambda: torch.nonzero(w))}
    rows = {}
    for name, (kern, plain, library) in timing.items():
        ms, device_ms = _timed(torch, kern, 20, flush, COMPACT_KERNEL)
        rows[name] = dict(n=w.numel(), live_rows=live, ms=ms, device_ms=device_ms,
                          plain_ms=_timed(torch, plain, 5, flush)[0],
                          bound_ms=bounds[name][0], bound_by=bounds[name][1],
                          library_ms=(_timed(torch, library, 10, flush)[0] if library
                                      else matmul_ms), max_abs_err=errs[name])
        print(f"opt-in kernel {name} dense (expected_pallas) N={w.numel()} live_rows={live}: "
              + json.dumps(rows[name]), flush=True)
    return rows


def optin_steps_phase(torch, ck, train, smi: str, steps: int):
    """Part 1 of the opt-in phase, from the train phase's state: a full-size
    VOC ``ori`` step in each other negative mode and one under the uint8
    augmentation law, and the quantized augmentation on the card against the
    CPU; see the module docstring.  Returns (the ``expected_pallas`` steps'
    launches, the dense kernel rows)."""
    from css_tpu_torch.losses import contrastive
    from css_tpu_torch.ops.augment import batch_transform
    from css_tpu_torch.train import train_step as ts
    from css_tpu_torch.train.draws import sample_augment_draws, sample_step_draws

    state, batch, g = train["state"], train["batch"], train["g"]
    c, crop, bsz = 21, 512, 8
    h, w = state.model.output_hw((crop, crop))
    ms, losses_in, class_calls, dense_calls = {}, [], [], []

    def runner(**overrides):
        cfg = ts.StepConfig(num_classes=c, crop_hw=(crop, crop), scale_range=(0.5, 1.5),
                            **overrides)
        step = ts.make_train_step(cfg)

        def one_step():
            draws = sample_step_draws(g, cfg, bsz, bsz, 2 * bsz * h * w)
            return step(state, batch, draws, 1.0)[1]
        return one_step

    # sampled_pallas first: the modes' yardstick, timed in this phase
    for mode in ("sampled_pallas", "expected", "expected_pallas", "sampled"):
        one_step, warmup = runner(negative_mode=mode), 1
        if mode == "expected_pallas":   # the warm-up records the loss's inputs, a dense call
            undo = [_record_calls(ts, "prototype_contrastive_loss", losses_in),
                    _record_calls(contrastive, "class_live_rows", class_calls),
                    _record_calls(contrastive, "weighted_exp_softsum_live", dense_calls)]
            try:
                one_step()
            finally:
                for put_back in undo:
                    put_back()
            warmup = 0
        ms[mode], peak, launches = _timed_steps(torch, ck, one_step, warmup, steps,
                                                c if mode.endswith("_pallas") else 0,
                                                f"opt-in {mode}")
        if mode == "expected_pallas":
            dense_launches = launches
        print(f"opt-in {mode} ({smi}): {ms[mode]:.3f} ms/step vs sampled_pallas "
              f"{ms['sampled_pallas']:.3f} ms/step in this phase "
              f"({ms[mode] / ms['sampled_pallas']:.4f}x), peak memory {peak:.3f} GiB", flush=True)

    # the dense kernel path against the plain product, on the step's own inputs
    args, kw = losses_in[0]
    detached = [x.detach() if torch.is_tensor(x) else x for x in args]
    kw = dict(kw, negative_mode="expected")
    plain = contrastive.prototype_contrastive_loss(*detached, **kw)[0].item()
    kw["negative_mode"] = "expected_pallas"
    dense = contrastive.prototype_contrastive_loss(*detached, **kw)[0].item()
    print(f"opt-in expected_pallas vs expected on the step's own inputs: contrastive loss "
          f"{dense:.6f} vs {plain:.6f} (gap {abs(dense - plain):.3e}, bound 2e-3)", flush=True)
    if not (math.isfinite(dense) and abs(dense - plain) <= 2e-3):
        raise RuntimeError(f"opt-in: expected_pallas loss {dense} vs expected {plain}")
    # class 0's dense weights, as the loss built them before the batched compaction
    (p_over_cnt, masked_cls, g_neg, _), _ = class_calls[0]
    (a, r, *_, inv_temp), _ = dense_calls[0]
    w_dense = p_over_cnt[0][masked_cls.long()]
    dense_rows = _dense_kernel_row(torch, ck, a.detach().to(torch.bfloat16), r, w_dense.detach(),
                                   inv_temp)
    dense_rows["class"] = _class_rows_row(torch, ck, _l2_flush(torch), p_over_cnt, masked_cls,
                                          g_neg, None, "expected_pallas step")
    del losses_in, class_calls, dense_calls, args, detached, kw, a, r, w_dense, p_over_cnt
    del masked_cls

    _timed_steps(torch, ck, runner(aug_quantize=True), 1, 1, c, "opt-in aug_quantize")
    # the quantized augmentation on the card against the CPU, with the same
    # draws, on a uint8 canvas as the driver feeds it
    draws = sample_augment_draws(g, bsz, (0.5, 1.5), photometric=True)
    canvas = torch.randint(0, 256, (bsz, crop, crop, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    confs = torch.rand(bsz, 1, crop, crop, generator=g, device="cuda")
    inputs = (canvas, batch["l_label"][:, None].long(), confs, batch["l_valid_hw"])

    def quantized(canvas, labels, confs, valid_hw, **kw):
        return batch_transform(ts._to01_cf(canvas), labels, confs, valid_hw, (crop, crop), **kw,
                               quantize=True)
    t0 = time.perf_counter()
    on_card = quantized(*inputs, **draws.as_kwargs())
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    on_cpu = quantized(*(x.cpu() for x in inputs),
                       **{k: v.cpu() for k, v in draws.as_kwargs().items()})
    err = (on_card[0].cpu() - on_cpu[0]).abs()
    exact = (err == 0).float().mean().item()
    same = [torch.equal(on_card[i].cpu(), on_cpu[i]) for i in (1, 2)]
    print(f"opt-in quantized batch_transform (b{bsz}, {crop}^2 uint8 canvas, photometric on): "
          f"card vs CPU largest gap {err.max().item() * 255:.3f} uint8 steps, exact share "
          f"{exact:.6f}, labels equal {same[0]}, confidences equal {same[1]}; {card_ms:.3f} ms "
          f"on the card (first call)", flush=True)
    if err.max().item() > 1.0 / 255.0 + 1e-6 or not all(same):
        raise RuntimeError("opt-in: the quantized augmentation on the card is more than one "
                           "uint8 step from the CPU's")
    return dense_launches, dense_rows


def optin_entry_phase(torch, smi: str, checkpoint: str):
    """Part 2 of the opt-in phase: ``evaluate`` and ``predict`` on the driver
    phase's checkpoint, and the sliding-window eval at the Cityscapes shapes
    on random weights; see the module docstring."""
    import numpy as np
    from PIL import Image

    from css_tpu_torch.cli import entries, evaluate_main, train_main
    from css_tpu_torch.config import CONFIG_DIR, load_config
    from css_tpu_torch.models.deeplabv3 import build_model
    from css_tpu_torch.train.train_step import make_eval_step, make_sliding_eval_step

    _free(torch)
    voc = os.path.join(CONFIG_DIR, VOC_YAML)
    argv = ["--config", voc, "--checkpoint", checkpoint, "--synthetic", "--num_labels", "32"]
    t0 = time.perf_counter()
    cm = evaluate_main.main(argv)
    seconds = time.perf_counter() - t0
    # the driver's _evaluate on the same checkpoint, eval number and crops
    cfg = load_config(voc)
    cfg.set("Dataset.name", "Synthetic")
    model, _, _ = evaluate_main.load_eval_model(cfg, checkpoint, False, torch.device("cuda"))
    args = entries.ori_pseudo_parser().parse_args(["--num_labels", "32"])
    loaders = train_main._make_loaders(cfg, args, cfg.require("Dataset.batch_size"))
    try:
        want = train_main._evaluate(make_eval_step(model, 21), loaders[2], (512, 512), 21,
                                    cfg.get("Seed"), evaluate_main.EVAL_INDEX,
                                    torch.device("cuda"))
    finally:
        for loader in loaders:
            loader.close()
    images = 2 * cfg.require("Dataset.batch_size")
    print(f"opt-in evaluate ({smi}): {seconds:.3f} s for {images} images with the model build "
          f"and restore; matrix total {int(cm.mat.sum())}, equal to the driver's _evaluate "
          f"{np.array_equal(cm.mat, want.mat)}", flush=True)
    if not np.array_equal(cm.mat, want.mat) or cm.mat.sum() == 0:
        raise RuntimeError("opt-in: evaluate's confusion matrix differs from the driver's")
    del model

    # sliding windows at the Cityscapes shapes: 769^2 windows over 1024 x 2048, 8 a canvas
    city = build_model(19, 256, "resnet101", dtype=torch.bfloat16, seed=5).to(
        "cuda", memory_format=torch.channels_last)
    g = torch.Generator(device="cuda").manual_seed(6)
    for label, b, flip, scales in (("plain", 2, False, (1.0,)),
                                   ("flip + scales 0.75,1.0", 1, True, (0.75, 1.0))):
        image = torch.randn(b, 1024, 2048, 3, generator=g, device="cuda")
        lab = torch.randint(0, 19, (b, 1024, 2048), generator=g, device="cuda")
        lab[torch.rand(b, 1024, 2048, generator=g, device="cuda") < 0.05] = -1
        lab[:, 1000:] = -1                          # padded canvas rows
        valid = torch.ones(b, dtype=torch.bool, device="cuda")
        step = make_sliding_eval_step(city, 19, (1024, 2048), (769, 769), flip=flip,
                                      scales=scales)
        zero = torch.zeros((19, 19), dtype=torch.int64, device="cuda")
        step(zero, image, lab, valid)               # cuDNN's picks for these shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mat = step(zero, image, lab, valid)
        total = int(mat.sum())
        ms = (time.perf_counter() - t0) * 1e3
        pixels = int((lab >= 0).sum())
        print(f"opt-in sliding eval {label} ({smi}): {ms / b:.3f} ms/image over {b} "
              f"1024x2048 canvas(es), 769^2 windows; matrix total {total}, valid label pixels "
              f"{pixels}", flush=True)
        if total != pixels:
            raise RuntimeError(f"opt-in: sliding eval counted {total} of {pixels} pixels")
    del city, image, lab
    _free(torch)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    try:
        sizes = [(375, 500), (512, 512), (600, 800), (333, 271)]   # (h, w); one past 512^2
        rng = np.random.default_rng(7)
        for i, (h, w) in enumerate(sizes):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(workdir, f"im{i}.png"))
        out = os.path.join(workdir, "out")
        t0 = time.perf_counter()
        entries.main(["predict", "--config", voc, "--checkpoint", checkpoint, "--inputs",
                      workdir, "--out_dir", out, "--overlay"])
        seconds = time.perf_counter() - t0
        got = [np.asarray(Image.open(os.path.join(out, f"im{i}_pred.png"))).shape
               for i in range(len(sizes))]
        overlays = [np.asarray(Image.open(os.path.join(out, f"im{i}_overlay.png"))).shape[:2]
                    for i in range(len(sizes))]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"opt-in predict ({smi}): {seconds:.3f} s for {len(sizes)} images with the model "
          f"build and restore; masks {got}, overlays {overlays}, inputs {sizes}", flush=True)
    if got != sizes or overlays != sizes:
        raise RuntimeError(f"opt-in: predict wrote masks {got} for inputs {sizes}")


def _free(torch):
    """Returns what earlier phases left to the allocator and resets the peak."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _city_state(torch, cfg):
    """The driver's own state and step for ``cfg`` (a loaded YAML), on the
    card: random weights from the YAML's seed (no pretrained trunk)."""
    from css_tpu_torch.cli import entries, train_main

    args = entries.ori_pseudo_parser().parse_args(["--synthetic"])
    state, step_cfg, step, _ = train_main._build_state_and_steps(cfg, args, torch.device("cuda"))
    return state, step_cfg, step


def _city_batch(torch, b: int, canvas, c: int):
    """A synthetic batch on the card: uint8 images on the full canvas, labels
    in [0, C) with 2% ignored (255)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    h, w = canvas
    lab = torch.randint(0, c, (b, h, w), generator=g, device="cuda", dtype=torch.int32)
    lab[torch.rand(b, h, w, generator=g, device="cuda") < 0.02] = 255
    full = torch.tensor([[h, w]] * b, dtype=torch.int32, device="cuda")

    def image():
        return torch.randint(0, 256, (b, h, w, 3), generator=g, device="cuda", dtype=torch.uint8)
    return {"l_image": image(), "l_label": lab, "l_valid_hw": full, "u_image": image(),
            "u_valid_hw": full}


def _ohem_on_card(torch, shape, c: int, min_kept: int):
    """OHEM at the recipe's shape on the card, under a sync-debug mode that
    raises on any host synchronisation, against the same call on the CPU."""
    from css_tpu_torch.losses.cross_entropy import ohem_cross_entropy

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(*shape, c, generator=g) * 3
    labels = torch.randint(0, c, shape, generator=g)
    labels[torch.rand(shape, generator=g) < 0.1] = -1
    want = ohem_cross_entropy(logits, labels, 0.7, min_kept)
    lg, lab = logits.cuda(), labels.cuda()
    ohem_cross_entropy(lg, lab, 0.7, min_kept)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        got = ohem_cross_entropy(lg, lab, 0.7, min_kept)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    print(f"cityscapes OHEM on the card, no host sync: loss {got.item():.6f} (CPU "
          f"{want.item():.6f}), {start.elapsed_time(end):.3f} ms at {list(shape)} x {c}",
          flush=True)


def cityscapes_phase(torch, ck, smi: str, steps: int):
    """The shipped Cityscapes recipe: fused and two-pass steps, a ``mix``
    step, a deep-stem remat step, OHEM alone, and the entry point; see the
    module docstring.  Returns the fused steps' launches."""
    import dataclasses
    import numpy as np

    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.config import CONFIG_DIR, load_config
    from css_tpu_torch.losses import cross_entropy as ce
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.train_step import make_train_step

    _free(torch)
    cfg = load_config(os.path.join(CONFIG_DIR, CITY_YAML))
    c, bsz = cfg.require("Network.num_class"), cfg.require("Dataset.batch_size")
    state, step_cfg, step = _city_state(torch, cfg)
    if not step_cfg.fused_forward or step_cfg.sup_loss != "ohem" or state.model.backbone.remat:
        raise RuntimeError(f"cityscapes: the shipped YAML built {step_cfg}")
    batch = _city_batch(torch, bsz, tuple(cfg.require("Dataset.canvas_size")), c)
    h, w = state.model.output_hw(step_cfg.crop_hw)
    g = torch.Generator(device="cuda").manual_seed(4)
    print(f"cityscapes: {step_cfg.crop_hw} crops of a {tuple(batch['l_image'].shape[1:3])} "
          f"canvas, b{bsz}+{bsz}, output {h}x{w}, contrastive table {2 * bsz * h * w} rows",
          flush=True)

    def runner(st, cfg_, fn, *extra):
        rows = 2 * bsz * int(np.prod(st.model.output_hw(cfg_.crop_hw)))

        def one_step():
            draws = sample_step_draws(g, cfg_, bsz, bsz, rows)
            return fn(st, batch, draws, 1.0, *extra)[1]
        return one_step

    kept, thresholds = [], []
    real_ce, real_keep = ce.per_pixel_cross_entropy, ce.ohem_keep_threshold

    # in eager steps only (a capture's tensors hold no values)
    def recording_ce(logits, labels):
        if not torch.cuda.is_current_stream_capturing():
            kept.append((labels >= 0).sum())
        return real_ce(logits, labels)

    def recording_keep(*args):
        threshold = real_keep(*args)
        if not torch.cuda.is_current_stream_capturing():
            thresholds.append(threshold)
        return threshold

    _graph_vs_eager(torch, "cityscapes fused", state, lambda: make_train_step(step_cfg), batch,
                    lambda: _seeded_draws(torch, step_cfg, bsz, 2 * bsz * h * w))
    fused = runner(state, step_cfg, step)
    ce.per_pixel_cross_entropy, ce.ohem_keep_threshold = recording_ce, recording_keep
    try:
        ms_fused, peak, launches = _timed_steps(torch, ck, fused, 2, steps, c, "cityscapes fused",
                                                graphed=True)
    finally:
        ce.per_pixel_cross_entropy, ce.ohem_keep_threshold = real_ce, real_keep
    if peak > CITY_PEAK_GIB_LIMIT:
        raise RuntimeError(f"cityscapes: peak memory {peak:.3f} GiB exceeds "
                           f"{CITY_PEAK_GIB_LIMIT} GiB")
    _class_path_pairs(torch, ck, fused, steps, c, "cityscapes fused")
    labeled = bsz * step_cfg.crop_hw[0] * step_cfg.crop_hw[1]
    print(f"cityscapes ({smi}): {ms_fused:.3f} ms/step, {2 * bsz * 1e3 / ms_fused:.3f} img/s, "
          f"peak memory {peak:.3f} GiB (limit {CITY_PEAK_GIB_LIMIT}); OHEM kept "
          f"{[int(k) for k in kept]} of {labeled} labeled pixels (min_kept "
          f"{step_cfg.ohem_min_kept_per_image * bsz}), thresholds "
          f"{[round(float(t), 6) for t in thresholds]} in the eager steps", flush=True)
    del step, fused         # and the fused step's graphs
    _free(torch)

    two_pass_cfg = dataclasses.replace(step_cfg, fused_forward=False)
    two_pass = runner(state, two_pass_cfg, make_train_step(two_pass_cfg))
    ms_two, peak_two, _ = _timed_steps(torch, ck, two_pass, 1, steps, c, "cityscapes two-pass")
    print(f"cityscapes fused {ms_fused:.3f} ms/step vs two-pass {ms_two:.3f} ms/step: "
          f"fused / two-pass {ms_fused / ms_two:.4f}; peaks {peak:.3f} / {peak_two:.3f} GiB",
          flush=True)
    del two_pass
    _free(torch)

    # the mix entry point's thresholds (strong 0.8, weak 0.7, unsupervised 0.97)
    mix_cfg = dataclasses.replace(step_cfg, strategy="mix", strong_threshold=0.8,
                                  weak_threshold=0.7, un_threshold=0.97, rep_temp=0.5)
    mix = runner(state, mix_cfg, make_train_step(mix_cfg), False)
    _timed_steps(torch, ck, mix, 1, 1, c, "cityscapes mix (fused teacher)")
    del state, mix, batch
    _free(torch)

    _ohem_on_card(torch, (bsz,) + tuple(step_cfg.crop_hw), c,
                  step_cfg.ohem_min_kept_per_image * bsz)

    stem_yaml = load_config(os.path.join(CONFIG_DIR, CITY_YAML))
    stem_yaml.set("Network.backbone", "resnet101_stem")
    del stem_yaml.data["Network"]["remat"]            # the default: on above 512^2
    stem = {}
    for policy in ("nothing", "save_mid"):
        stem_yaml.set("Network.remat_policy", policy)
        state, stem_cfg, step = _city_state(torch, stem_yaml)
        trunk = state.model.backbone
        if trunk.remat is not True or trunk.remat_policy != policy:
            raise RuntimeError(f"cityscapes: the deep-stem trunk is not remat'd with {policy}")
        batch = _city_batch(torch, bsz, tuple(cfg.require("Dataset.canvas_size")), c)
        stem[policy] = _timed_steps(torch, ck, runner(state, stem_cfg, step), 1, steps, c,
                                    f"cityscapes resnet101_stem + remat ({policy})")
        del state, step, batch, trunk
        _free(torch)
    (ms_n, peak_n, _), (ms_s, peak_s, _) = stem["nothing"], stem["save_mid"]
    print(f"cityscapes resnet101_stem + remat ({smi}): save_mid {ms_s:.3f} ms/step, peak "
          f"{peak_s:.3f} GiB; nothing {ms_n:.3f} ms/step, peak {peak_n:.3f} GiB; save_mid / "
          f"nothing {ms_s / ms_n:.4f}x time, {peak_s / peak_n:.4f}x peak; fused step "
          f"{ms_fused:.3f} ms/step", flush=True)

    args = entries.ori_pseudo_parser().parse_args(
        ["--config", os.path.join(CONFIG_DIR, CITY_YAML), "--synthetic", "--num_labels", "8",
         "--total_iter", "2", "--max_steps", "2", "--job_name", "smoke"])
    workdir = tempfile.mkdtemp(prefix="chip_smoke_city_")
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        with _DriverProbe(torch, train_main) as probe:
            ck.reset_launches()
            replays = REPLAYS[0]
            t0 = time.perf_counter()
            result = train_main.run_training("ori", args)
            seconds = time.perf_counter() - t0
            entry_launches = dict(ck.LAUNCHES)
            replayed = REPLAYS[0] - replays
        peak_entry = torch.cuda.max_memory_allocated() / 2**30
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    losses = [{k: v.item() for k, v in m.items()} for m in probe.losses]
    _check_finite(losses, "cityscapes entry point")
    if result["steps"] != 2 or len(probe.evals) != 1:
        raise RuntimeError(f"cityscapes entry point: {result['steps']} steps, "
                           f"{len(probe.evals)} evals")
    _check_launches(f"cityscapes entry point (2 steps, {replayed} replayed)", entry_launches,
                    2 - replayed, c)
    e = probe.evals[0]
    print(f"cityscapes entry point: {seconds:.3f} s wall, {json.dumps(result)}, losses "
          f"{json.dumps(losses)}, eval {e['seconds'] * 1e3 / e['images']:.3f} ms/image over "
          f"{e['images']} images ({e['pixels']} valid label pixels counted), peak memory "
          f"{peak_entry:.3f} GiB, launches {json.dumps(entry_launches)}", flush=True)
    return launches


def segformer_phase(torch, ck, smi: str, steps: int):
    """The shipped SegFormer-B5 YAML's step; see the module docstring.
    Returns its launches."""
    from css_tpu_torch.config import CONFIG_DIR, load_config
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.train_step import make_train_step

    _free(torch)
    cfg = load_config(os.path.join(CONFIG_DIR, SEGFORMER_YAML))
    c, bsz = cfg.require("Network.num_class"), cfg.require("Dataset.batch_size")
    state, step_cfg, step = _city_state(torch, cfg)
    if type(state.model).__name__ != "SegFormerDual":
        raise RuntimeError(f"segformer: the shipped YAML built {type(state.model).__name__}")
    batch = _voc_batch(torch, bsz, step_cfg.crop_hw[0], c)
    h, w = state.model.output_hw(step_cfg.crop_hw)
    rows = 2 * bsz * h * w
    _graph_vs_eager(torch, "segformer", state, lambda: make_train_step(step_cfg), batch,
                    lambda: _seeded_draws(torch, step_cfg, bsz, rows))
    g = torch.Generator(device="cuda").manual_seed(6)

    def one_step():
        return step(state, batch, sample_step_draws(g, step_cfg, bsz, bsz, rows), 1.0)[1]

    ms, peak, launches = _timed_steps(torch, ck, one_step, 2, steps, c, "segformer",
                                      graphed=True)
    print(f"segformer ({smi}): {ms:.3f} ms/step, {2 * bsz * 1e3 / ms:.3f} img/s, peak memory "
          f"{peak:.3f} GiB", flush=True)
    del state, step, one_step, batch
    _free(torch)
    return launches


def _grad_norm(torch, module) -> float:
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in module.parameters() if p.grad is not None])).item()


def _world_one(torch, ck, smi: str, steps: int, train_ms: float):
    """Part 1 of the distributed phase, inside a 1-rank NCCL group."""
    import copy
    import dataclasses

    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.config import CONFIG_DIR, load_config
    from css_tpu_torch.models.deeplabv3 import set_distributed
    from css_tpu_torch.models.resnet import GroupedBatchNorm
    from css_tpu_torch.train.checkpoint import state_sha256
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.train_step import make_train_step

    cfg = load_config(os.path.join(CONFIG_DIR, VOC_YAML))
    args = entries.ori_pseudo_parser().parse_args(["--synthetic"])
    state, step_cfg, step, _ = train_main._build_state_and_steps(
        cfg, args, torch.device("cuda"), "ori", distributed=True)
    bns = [m for m in state.model.modules() if isinstance(m, GroupedBatchNorm)]
    teacher_bns = [m for m in state.teacher.modules() if isinstance(m, GroupedBatchNorm)]
    if not (step_cfg.distributed and all(m.distributed for m in bns + teacher_bns)):
        raise RuntimeError("distributed: the builder did not make a cross-replica model and step")
    c, bsz = step_cfg.num_classes, cfg.require("Dataset.batch_size")
    batch = _voc_batch(torch, bsz, step_cfg.crop_hw[0], c)
    h, w = state.model.output_hw(step_cfg.crop_hw)
    g = torch.Generator(device="cuda").manual_seed(5)

    def draws():
        return sample_step_draws(g, step_cfg, bsz, bsz, 2 * bsz * h * w)

    # step 1: the distributed step against the plain one, same state and
    # draws; the plain step twice shows how far the card repeats itself
    first = draws()
    plain, again = copy.deepcopy(state), copy.deepcopy(state)
    for st in (plain, again):
        set_distributed(st.model, False)
        set_distributed(st.teacher, False)
    plain_step = make_train_step(dataclasses.replace(step_cfg, distributed=False))
    with _eager_steps():                # as the distributed step runs
        m_plain = {k: v.item() for k, v in plain_step(plain, batch, first, 1.0)[1].items()}
        plain_step(again, batch, first, 1.0)
    m_dist = {k: v.item() for k, v in step(state, batch, first, 1.0)[1].items()}
    gaps = {k: abs(m_dist[k] - m_plain[k]) / max(abs(m_plain[k]), 1e-12) for k in m_plain}

    def compare(a, b):   # reported, not checked: cuDNN may pick other algorithms
        gap = max((p - q).abs().max().item()
                  for p, q in zip(a.model.parameters(), b.model.parameters()))
        return (f"bit-equal {state_sha256(a) == state_sha256(b)}, largest student parameter "
                f"gap {gap:.3e}")

    print(f"distributed world 1: step 1 losses {json.dumps(m_dist)} vs the plain step "
          f"{json.dumps(m_plain)}, relative gaps {json.dumps(gaps)}; states after the step "
          f"(student, teacher, BN stats, momentum, prototypes): distributed vs plain "
          f"{compare(state, plain)}; plain vs plain again {compare(again, plain)}", flush=True)
    del plain, again, st
    for k in m_plain:
        if not (math.isfinite(m_dist[k]) and abs(m_dist[k] - m_plain[k])
                <= DIST_LOSS_RTOL * abs(m_plain[k]) + 1e-6):
            raise RuntimeError(f"distributed world 1: {k} {m_dist[k]} vs plain {m_plain[k]}")

    def one_step():
        return step(state, batch, draws(), 1.0)[1]

    torch.cuda.reset_peak_memory_stats()
    ms, peak, launches = _timed_steps(torch, ck, one_step, 1, steps, c, "distributed world 1")
    print(f"distributed world 1 (NCCL, {smi}): {ms:.3f} ms/step vs the train phase's bare step "
          f"{train_ms:.3f} ms/step ({ms / train_ms:.4f}x), peak memory {peak:.3f} GiB", flush=True)

    # the unsupervised loss's gradient path: every pixel passes at threshold 0
    thr_draws = draws()
    out = {}
    for thr in (0.0, 0.97):
        copy_ = copy.deepcopy(state)
        thr_step = make_train_step(dataclasses.replace(step_cfg, un_threshold=thr))
        metrics = thr_step(copy_, batch, thr_draws, 1.0)[1]
        out[thr] = (metrics["unsup"].item(), metrics["total"].item(),
                    _grad_norm(torch, copy_.model))
        del copy_
    (unsup0, total0, norm0), (unsup97, total97, norm97) = out[0.0], out[0.97]
    print(f"distributed world 1 un_threshold 0: unsup {unsup0:.6f}, total {total0:.6f}, student "
          f"gradient norm {norm0:.6f}; at 0.97: unsup {unsup97:.6f}, total {total97:.6f}, "
          f"gradient norm {norm97:.6f}", flush=True)
    if not (math.isfinite(unsup0) and unsup0 > 0 and math.isfinite(norm0) and norm0 != norm97):
        raise RuntimeError(f"distributed: the unsupervised path at threshold 0 gave unsup "
                           f"{unsup0}, gradient norm {norm0} (0.97: {norm97})")
    return launches


def _dist_rank(device, argv):
    """One rank of part 2 of the distributed phase: the driver's per-rank
    loop under a probe; returns what the parent checks and prints."""
    import torch

    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.ops.kernels import contrastive_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(device)
    with _DriverProbe(torch, train_main) as probe:
        ck.reset_launches()
        t0 = time.perf_counter()
        result = train_main.train_on(device, "ori", entries.ori_pseudo_parser().parse_args(argv))
        seconds = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
    return dict(rank=torch.distributed.get_rank(), backend=torch.distributed.get_backend(),
                device=str(device), result=result, launches=launches, seconds=seconds,
                losses=[{k: v.item() for k, v in m.items()} for m in probe.losses],
                step_ms=probe.step_ms(), evals=probe.evals,
                saves=[name for name, _, _ in probe.saves],
                save_s=[s for _, s, _ in probe.saves],
                step_at=[t - t0 for t in probe.step_at],
                peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)


def _two_ranks(torch, workdir: str, smi: str):
    """Part 2 of the distributed phase."""
    from css_tpu_torch import parallel
    from css_tpu_torch.config import CONFIG_DIR, dump_config, load_config

    cards = torch.cuda.device_count()
    if cards >= 2:
        backend, devices = "nccl", ["cuda:0", "cuda:1"]
    else:
        backend, devices = "gloo", ["cuda:0", "cuda:0"]
    cfg = load_config(os.path.join(CONFIG_DIR, VOC_YAML))
    per_rank = cfg.require("Dataset.batch_size") // (1 if cards >= 2 else 2)
    cfg.set("Dataset.batch_size", per_rank)
    cfg.set("Training_Setting.save_dir", os.path.join(workdir, "checkpoints"))
    config = dump_config(cfg, os.path.join(workdir, "two_ranks_yaml"))
    steps = 3
    argv = ["--config", config, "--synthetic", "--job_name", "smoke", "--num_labels",
            str(steps * 2 * per_rank), "--total_iter", str(steps)]
    t0 = time.perf_counter()
    ranks = parallel.spawn(_dist_rank, (argv,), 2, backend, devices, workdir=workdir)
    seconds = time.perf_counter() - t0
    job = os.path.join(workdir, "checkpoints", "smoke")
    log = open(os.path.join(job, "train.log")).read()
    for r in ranks:
        _check_finite(r["losses"], f"distributed rank {r['rank']}")
        print(f"distributed rank {r['rank']} ({r['backend']} on {r['device']}, b{per_rank}+"
              f"{per_rank}, {smi}): {json.dumps(r['result'])}; device-timeline ms between step "
              f"ends {json.dumps(r['step_ms'])}; {r['seconds']:.3f} s in train_on (steps entered "
              f"at {json.dumps([round(t, 3) for t in r['step_at']])} s, eval "
              f"{json.dumps([round(e['seconds'], 3) for e in r['evals']])} s, saves "
              f"{json.dumps([round(t, 3) for t in r['save_s']])} s); peak memory "
              f"{r['peak_gib']:.3f} GiB; losses {json.dumps(r['losses'])}; launches "
              f"{json.dumps(r['launches'])}; saves {r['saves']}", flush=True)
        if len(r["losses"]) != steps:
            raise RuntimeError(f"distributed rank {r['rank']}: {len(r['losses'])} steps")
        _check_launches(f"distributed rank {r['rank']}", r["launches"], steps)
        if r["result"]["steps"] != steps or len(r["evals"]) != 1:
            raise RuntimeError(f"distributed rank {r['rank']}: {r['result']}, {r['evals']}")
    digests = [r["result"]["state_sha256"][r["rank"]] for r in ranks]
    if len(set(digests)) != 1:
        raise RuntimeError(f"distributed: the ranks' states differ: {digests}")
    if ranks[0]["saves"] != ["best_model", "last_model"] or ranks[1]["saves"]:
        raise RuntimeError(f"distributed: saves {[r['saves'] for r in ranks]}, want rank 0's only")
    if log.count("device=") != 1 or log.count("* mIoU") != 1:
        raise RuntimeError(f"distributed: train.log is not rank 0's alone:\n{log}")
    pixels = sum(r["evals"][0]["pixels"] for r in ranks)
    images = sum(r["evals"][0]["images"] for r in ranks)
    totals = [r["evals"][0]["total"] for r in ranks]
    if totals != [pixels, pixels]:
        raise RuntimeError(f"distributed: eval matrix totals {totals}, want {pixels} (the valid "
                           f"label pixels of both shards)")
    print(f"distributed two ranks: {backend} on {devices} ({cards} card(s)), b{per_rank}+"
          f"{per_rank} per rank; {seconds:.3f} s wall for the spawn; states bit-equal (sha256 "
          f"{digests[0][:16]}); eval counted {pixels} valid label pixels over {images} images "
          f"of both shards; a correctness run, not a speed reading", flush=True)
    if cards < 2:
        print("distributed: one card here, so cross-card NCCL was not run; cross-rank parity "
              "rests on the CPU gloo tests (tests/test_torch_distributed_*.py)", flush=True)
    return os.path.join(job, "last_model"), [r["launches"] for r in ranks]


def _elastic_resume(torch, workdir: str, last: str):
    """Part 3 of the distributed phase: one process resumes the 2-rank run."""
    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.config import CONFIG_DIR

    saved = torch.load(last, map_location="cpu", weights_only=True)
    args = entries.ori_pseudo_parser().parse_args(
        ["--config", os.path.join(CONFIG_DIR, VOC_YAML), "--synthetic", "--job_name", "resumed",
         "--num_labels", "16", "--total_iter", "8", "--max_steps", str(saved["step"] + 1),
         "--resume", last])
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        with _DriverProbe(torch, train_main) as probe:
            result = train_main.run_training("ori", args)
    finally:
        os.chdir(cwd)
    start_step, start_protos = probe.start
    if (start_step != saved["step"] or not torch.equal(start_protos.cpu(), saved["prototypes"])
            or result["steps"] != saved["step"] + 1):
        raise RuntimeError(f"distributed resume: started at step {start_step} (saved "
                           f"{saved['step']}), ended at {result['steps']}, prototypes equal "
                           f"{torch.equal(start_protos.cpu(), saved['prototypes'])}")
    _check_finite([{k: v.item() for k, v in m.items()} for m in probe.losses], "distributed resume")
    print(f"distributed resume on one process from the 2-rank last_model: started at step "
          f"{start_step} with the saved prototypes (bit-equal), {json.dumps(result)}", flush=True)


def distributed_phase(torch, ck, smi: str, steps: int, train_ms: float):
    """Data parallelism: a 1-rank NCCL group at the VOC width, two ranks
    through the driver's launcher, and a resume at another world size; see
    the module docstring.  Returns (the world-1 launches, each rank's)."""
    _free(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        torch.distributed.init_process_group(
            "nccl", init_method="file://" + os.path.join(workdir, "rendezvous"), rank=0,
            world_size=1)
        try:
            launches = _world_one(torch, ck, smi, steps, train_ms)
        finally:
            torch.distributed.destroy_process_group()
        _free(torch)
        last, rank_launches = _two_ranks(torch, workdir, smi)
        _elastic_resume(torch, workdir, last)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches, rank_launches


def _reference_payload(torch, c: int, d: int, seed: int) -> dict:
    """A reference (PyTorch CSS) training checkpoint for ResNet-101 under
    the reference's own names (``DeepLabv3Plus_with_rep``: the trunk under
    ``resnet_``, ``ASPP.convs.{0..4}``, ``ASPP.project``, ``project``, the
    ``classifier`` and ``representation`` heads), written out here from a
    seeded generator, not through the port's loader: convolutions
    kaiming-normal (fan out), BatchNorms near their fresh values."""
    g = torch.Generator().manual_seed(seed)

    def net():
        sd = {}

        def conv(name, o, i, k, bias=False):
            sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * math.sqrt(2 / (o * k * k))
            if bias:
                sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.01

        def bn(name, ch):
            sd[f"{name}.weight"] = 1 + 0.1 * torch.rand(ch, generator=g)
            sd[f"{name}.bias"] = 0.01 * torch.randn(ch, generator=g)
            sd[f"{name}.running_mean"] = 0.01 * torch.randn(ch, generator=g)
            sd[f"{name}.running_var"] = 1 + 0.1 * torch.rand(ch, generator=g)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

        conv("resnet_conv1", 64, 3, 7)
        bn("resnet_bn1", 64)
        inplanes = 64
        for layer, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3)), 1):
            for b in range(blocks):
                p = f"resnet_layer{layer}.{b}"
                conv(f"{p}.conv1", planes, inplanes, 1)
                bn(f"{p}.bn1", planes)
                conv(f"{p}.conv2", planes, planes, 3)
                bn(f"{p}.bn2", planes)
                conv(f"{p}.conv3", planes * 4, planes, 1)
                bn(f"{p}.bn3", planes * 4)
                if b == 0:
                    conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                inplanes = planes * 4
        for i, k in enumerate((1, 3, 3, 3)):
            conv(f"ASPP.convs.{i}.0", 256, 2048, k)
            bn(f"ASPP.convs.{i}.1", 256)
        conv("ASPP.convs.4.1", 256, 2048, 1)             # .0 is the global pool
        bn("ASPP.convs.4.2", 256)
        conv("ASPP.project.0", 256, 5 * 256, 1)
        bn("ASPP.project.1", 256)
        conv("project.0", 48, 256, 1)
        bn("project.1", 48)
        for head, out in (("classifier", c), ("representation", d)):
            conv(f"{head}.0", 256, 304, 3)
            bn(f"{head}.1", 256)
            conv(f"{head}.3", out, 256, 1, bias=True)
        return sd

    return {"epoch": 0, "model": net(), "ema_model": net(), "optimizer": {}, "lr_scheduler": {},
            "prototypes": torch.randn(c, d, generator=g)}


def _digests(sd) -> list:
    """The sorted SHA-256 digests of the float tensors of ``sd``."""
    import hashlib

    return sorted(hashlib.sha256(v.detach().float().cpu().contiguous().numpy().tobytes())
                  .hexdigest() for v in sd.values() if v.is_floating_point())


def _voc_yaml(workdir: str, name: str, **overrides) -> str:
    """The shipped VOC YAML with ``overrides`` (dotted keys), written to
    ``workdir/name``; its save_dir under ``workdir``."""
    from css_tpu_torch.config import CONFIG_DIR, dump_config, load_config

    cfg = load_config(os.path.join(CONFIG_DIR, VOC_YAML))
    cfg.set("Training_Setting.save_dir", os.path.join(workdir, "checkpoints"))
    for key, value in overrides.items():
        cfg.set(key, value)
    return dump_config(cfg, os.path.join(workdir, name))


def _driver_run(torch, ck, argv, label: str, steps: int):
    """``ori`` through the driver's entry point under a probe: finite
    losses, ``steps`` steps, one eval that counted every valid label pixel,
    one contrastive loss's launches a step whose Python ran (the eager and
    the captured ones).  Returns (result, launches,
    probe, seconds)."""
    from css_tpu_torch.cli import entries, train_main

    with _DriverProbe(torch, train_main) as probe:
        ck.reset_launches()
        replays = REPLAYS[0]
        t0 = time.perf_counter()
        result = train_main.run_training("ori", entries.ori_pseudo_parser().parse_args(argv))
        seconds = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        replayed = REPLAYS[0] - replays
    losses = [{k: v.item() for k, v in m.items()} for m in probe.losses]
    _check_finite(losses, label)
    if result["steps"] != steps or len(losses) != steps or len(probe.evals) != 1:
        raise RuntimeError(f"{label}: {result}, {len(losses)} steps, {len(probe.evals)} evals")
    _check_launches(f"{label} ({replayed} replayed)", launches, steps - replayed)
    e = probe.evals[0]
    print(f"{label}: {seconds:.3f} s wall, {json.dumps(result)}, losses {json.dumps(losses)}, "
          f"eval {e['images']} images ({e['pixels']} valid label pixels counted), launches "
          f"{json.dumps(launches)}", flush=True)
    return result, launches, probe, seconds


def import_phase(torch, ck, smi: str, workdir: str):
    """A reference checkpoint through ``entries import``, ``--resume`` and
    ``evaluate``; see the module docstring.  Returns (the resumed steps'
    launches, the imported checkpoint's path)."""
    from css_tpu_torch.cli import entries, evaluate_main

    _free(torch)
    c, d = 21, 256
    payload = _reference_payload(torch, c, d, seed=11)
    pth = os.path.join(workdir, "reference_best_model.pth")
    torch.save(payload, pth)
    out = os.path.join(workdir, "imported")
    config = _voc_yaml(workdir, "import_yaml")
    t0 = time.perf_counter()
    entries.main(["import", "--torch_ckpt", pth, "--config", config, "--out", out,
                  "--total_iter", "4"])
    import_s = time.perf_counter() - t0
    saved = torch.load(out, map_location="cpu", weights_only=True)
    for net, port in (("model", "model"), ("ema_model", "teacher")):
        if _digests(payload[net]) != _digests(saved[port]):
            raise RuntimeError(f"import: the {net} tensors did not all land in the {port}")
    for port, ref in (("backbone.layer4_2.conv2.conv.weight", "resnet_layer4.2.conv2.weight"),
                      ("backbone.stem.bn.running_var", "resnet_bn1.running_var"),
                      ("aspp.pool_conv.conv.weight", "ASPP.convs.4.1.weight"),
                      ("classifier.out.bias", "classifier.3.bias")):
        if not torch.equal(saved["model"][port].cpu(), payload["model"][ref]):
            raise RuntimeError(f"import: {port} is not the reference's {ref}")
    if not (torch.equal(saved["prototypes"].cpu(), payload["prototypes"])
            and saved["epoch"] == 0 and saved["step"] == 0 and not saved["optimizer"]["state"]):
        raise RuntimeError("import: prototypes, epoch, step or a fresh optimizer wrong")
    tensors = sum(1 for v in payload["model"].values() if v.is_floating_point())
    print(f"import ({smi}): {import_s:.3f} s for a ResNet-101 reference checkpoint "
          f"({os.path.getsize(pth) / 2**30:.3f} GiB) through entries import on the card; "
          f"{tensors} tensors each of student and teacher landed (SHA-256 multisets equal), "
          f"prototypes, epoch 0 and a fresh optimizer", flush=True)
    del payload, saved
    _free(torch)

    _, launches, _, _ = _driver_run(
        torch, ck, ["--config", config, "--synthetic", "--job_name", "imported", "--num_labels",
                    "16", "--total_iter", "4", "--max_steps", "2", "--resume", out],
        "import: --resume from the imported checkpoint", 2)
    _free(torch)
    t0 = time.perf_counter()
    cm = evaluate_main.main(["--config", config, "--checkpoint", out, "--synthetic",
                             "--num_labels", "16"])
    seconds = time.perf_counter() - t0
    print(f"import: evaluate of the imported checkpoint ({smi}): {seconds:.3f} s with the build "
          f"and restore, matrix total {int(cm.mat.sum())}", flush=True)
    if cm.mat.sum() == 0:
        raise RuntimeError("import: evaluate counted no pixel")
    return launches, out


def _eval_rank(device, args):
    """One gloo rank of the evaluate-ranks phase: ``evaluate_on`` under the
    parent's numerics flags (no TF32, cuDNN's deterministic heuristic
    picks); returns the rank's matrix (the sum over the ranks)."""
    import torch

    from css_tpu_torch.cli import evaluate_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return evaluate_main.evaluate_on(device, args)[0].mat


def evaluate_ranks_phase(torch, smi: str, workdir: str, checkpoint: str, root: str):
    """``evaluate`` of ``checkpoint`` on the files phase's VOC tree at b1:
    in this process, inside a 1-rank NCCL group, and over two gloo ranks on
    one card; the sharded matrices must equal the one-process one.  Every
    run takes the same one-image batches with cuDNN's deterministic
    heuristic picks: a timed pick may differ from process to process, and
    on the card an image's bf16 logits can depend on its place in a larger
    batch (b4 batches of other images moved some pixels to another class),
    so each image is computed the same way only alone."""
    import numpy as np

    from css_tpu_torch import parallel
    from css_tpu_torch.cli import evaluate_main

    _free(torch)
    config = _voc_yaml(workdir, "ranks_yaml", **{"Dataset.batch_size": 1,
                                                 "Dataset.data_dir": root,
                                                 "Dataset.txt_dir": os.path.join(root, "splits")})
    argv = ["--config", config, "--checkpoint", checkpoint, "--num_labels", "16"]
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        want = evaluate_main.main(argv).mat
        one_s = time.perf_counter() - t0
        torch.distributed.init_process_group(
            "nccl", init_method="file://" + os.path.join(workdir, "eval_rendezvous"), rank=0,
            world_size=1)
        try:
            t0 = time.perf_counter()
            nccl = evaluate_main.main(argv + ["--num_devices", "1"]).mat
            nccl_s = time.perf_counter() - t0
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.benchmark = benchmark
        torch.backends.cudnn.deterministic = False
    _free(torch)
    t0 = time.perf_counter()
    ranks = parallel.spawn(_eval_rank, (evaluate_main.evaluate_parser().parse_args(argv),), 2,
                           "gloo", ["cuda:0", "cuda:0"], workdir=workdir)
    gloo_s = time.perf_counter() - t0
    gaps = [int(np.abs(m - want).sum()) for m in (nccl, *ranks)]
    print(f"evaluate-ranks ({smi}): 16 VOC files at b1; one process {one_s:.3f} s, 1-rank NCCL "
          f"group {nccl_s:.3f} s, two gloo ranks on one card {gloo_s:.3f} s for the spawn; "
          f"matrix total {int(want.sum())}; entries apart from the one-process matrix (NCCL, "
          f"gloo rank 0, gloo rank 1): {gaps}", flush=True)
    if any(gaps) or want.sum() == 0:
        raise RuntimeError("evaluate-ranks: a sharded matrix differs from the one-process one")


def _smooth_image(rng, h: int, w: int):
    """A uint8 image of smooth colour blobs with pixel noise: compresses as
    a photograph does, unlike white noise."""
    import numpy as np

    yy = np.linspace(0, 3 * np.pi, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 3 * np.pi, w, dtype=np.float32)[None, :]
    ph, fr = rng.random(6) * 2 * np.pi, rng.random(6) + 0.5
    chans = [np.sin(fr[i] * yy + ph[i]) * np.cos(fr[i + 3] * xx + ph[i + 3]) for i in range(3)]
    img = (np.stack(chans, -1) + 1) * 110 + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_file_trees(root: str):
    """16 VOC-layout JPEGs (500 x 375 and 375 x 500, quality 90) with
    palette PNG labels and split lists for 16 labels, and 8
    Cityscapes-layout 2048 x 1024 RGB PNGs with trainIds PNG labels;
    returns (VOC ids, Cityscapes ids)."""
    import concurrent.futures as cf

    import numpy as np
    from PIL import Image

    voc_ids = [f"2007_{i:06d}" for i in range(16)]
    city_ids = [f"aachen_{i:06d}_000019_leftImg8bit" for i in range(8)]
    for sub in ("JPEGImages", "SegmentationClassAug", "splits/16/3407",
                "leftImg8bit/val/aachen", "gtFine/val/aachen"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def voc(i):
        rng = np.random.default_rng(100 + i)
        h, w = (375, 500) if i % 2 else (500, 375)
        Image.fromarray(_smooth_image(rng, h, w)).save(
            os.path.join(root, "JPEGImages", f"{voc_ids[i]}.jpg"), quality=90)
        lab = (rng.integers(0, 21) + np.arange(h)[:, None] // 40 + np.arange(w)[None] // 60) % 21
        lab = lab.astype(np.uint8)
        lab[: h // 20] = 255
        im = Image.fromarray(lab, mode="P")
        im.putpalette(list(rng.integers(0, 256, 768, dtype=np.uint8)))
        im.save(os.path.join(root, "SegmentationClassAug", f"{voc_ids[i]}.png"))

    def city(i):
        rng = np.random.default_rng(200 + i)
        Image.fromarray(_smooth_image(rng, 1024, 2048)).save(
            os.path.join(root, "leftImg8bit", "val", "aachen", f"{city_ids[i]}.png"))
        lab = ((np.arange(1024)[:, None] // 64 + np.arange(2048)[None] // 128) % 19).astype(
            np.uint8)
        lab[rng.random((1024, 2048)) < 0.05] = 255
        Image.fromarray(lab, mode="L").save(os.path.join(
            root, "gtFine", "val", "aachen", city_ids[i][:-len("_leftImg8bit")]
            + "_gtFine_trainIds.png"))

    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(voc, range(16)))
        list(pool.map(city, range(8)))
    for name in ("labeled", "unlabeled", "valid"):
        with open(os.path.join(root, "splits", "16", "3407", f"{name}_filename.txt"), "w") as f:
            f.write("\n".join(voc_ids) + "\n")
    return voc_ids, city_ids


def _loader_ms(spec, ids, batch: int, passes: int) -> list:
    """Host ms per batch of the driver's loader over ``ids``, one reading a
    pass, nothing else running."""
    from css_tpu_torch.data import BatchLoader

    loader = BatchLoader(spec, ids, batch, seed=3407, shuffle=False, drop_last=True)
    try:
        out = []
        for _ in range(passes):
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            out.append((time.perf_counter() - t0) * 1e3 / n)
        return out
    finally:
        loader.close()


def files_phase(torch, ck, smi: str, workdir: str):
    """Real-format files: every file decoded by the host decoder and by PIL
    (equal on every pixel), the loader's ms per batch each way for both
    recipes, and 2 driver steps on the VOC tree; see the module docstring.
    Returns (the steps' launches, the tree's root)."""
    import contextlib
    import unittest.mock

    import numpy as np
    from PIL import Image

    from css_tpu_torch.data import CityscapesSpec, VOCSpec, decoder_line, native_io

    root = os.path.join(workdir, "files")
    t0 = time.perf_counter()
    voc_ids, city_ids = _write_file_trees(root)
    mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 2**20
    print(f"files: wrote 16 VOC JPEG + PNG pairs and 8 Cityscapes 2048x1024 PNG pairs, "
          f"{mb:.1f} MiB, in {time.perf_counter() - t0:.1f} s", flush=True)
    line = decoder_line("VOC")
    print(f"files: {line}", flush=True)
    voc = VOCSpec(root=root, canvas_hw=(512, 512))
    city = CityscapesSpec(root=root, mode="val", canvas_hw=(1024, 2048))
    if native_io.native_available():
        checked = 0
        for spec, ids, decode in ((voc, voc_ids, native_io.decode_jpeg_canvas),
                                  (city, city_ids, native_io.decode_png_rgb_canvas)):
            ch, cw = spec.canvas_hw
            for sid in ids:
                img_path, lab_path = spec._paths(sid)
                icanvas = np.zeros((ch, cw, 3), np.uint8)
                lcanvas = np.full((ch, cw), 255, np.int32)
                hw = decode(img_path, icanvas)
                lhw = native_io.decode_png_label_canvas(lab_path, lcanvas)
                with Image.open(img_path) as im:
                    img = np.asarray(im.convert("RGB"))
                with Image.open(lab_path) as im:
                    lab = np.asarray(im)
                h, w = img.shape[:2]
                if hw != (h, w) or lhw != (h, w):
                    raise RuntimeError(f"files: {sid} decoded at {hw}/{lhw}, PIL {(h, w)}")
                gap = int(np.abs(icanvas[:h, :w].astype(np.int32) - img).max())
                if gap or not np.array_equal(lcanvas[:h, :w], lab):
                    raise RuntimeError(f"files: {sid}: native and PIL differ (image gap {gap}, "
                                       f"labels equal {np.array_equal(lcanvas[:h, :w], lab)})")
                checked += 1
        print(f"files: {checked} images and their labels decoded natively equal PIL's on every "
              f"pixel", flush=True)
    else:
        print("files: the host decoder did not build here, so only PIL was read", flush=True)

    readings = {}
    for label, spec, ids, batch in (("VOC", voc, voc_ids, 8), ("Cityscapes", city, city_ids, 4)):
        for decoder in ("native", "pil", "native", "pil"):
            if decoder == "native" and not native_io.native_available():
                continue
            forced = (unittest.mock.patch.object(native_io, "native_available", lambda: False)
                      if decoder == "pil" else contextlib.nullcontext())
            with forced:
                readings.setdefault((label, decoder), []).extend(_loader_ms(spec, ids, batch, 2))
    for (label, decoder), ms in readings.items():
        print(f"files loader alone ({smi}), {label}, {decoder}: "
              f"{json.dumps([round(m, 3) for m in ms])} ms per batch "
              f"(median {statistics.median(ms):.3f}; b{8 if label == 'VOC' else 4}, "
              f"8 decode threads)", flush=True)

    config = _voc_yaml(workdir, "files_yaml", **{"Dataset.data_dir": root,
                                                 "Dataset.txt_dir": os.path.join(root, "splits")})
    _free(torch)
    _, launches, _, _ = _driver_run(
        torch, ck, ["--config", config, "--job_name", "files", "--num_labels", "16",
                    "--total_iter", "2", "--max_steps", "2"], f"files: 2 driver steps ({line})", 2)
    log = open(os.path.join(workdir, "checkpoints", "files", "train.log")).read()
    if line not in log:
        raise RuntimeError(f"files: train.log does not name the decoder ({line})")
    return launches, root


def os16_phase(torch, ck, smi: str, steps: int):
    """The VOC ``ori`` step at output stride 16 beside output stride 8, 1
    warm-up + ``steps`` timed steps each from random weights; ms/step and
    peak memory of each."""
    from css_tpu_torch.models.deeplabv3 import build_model
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.state import create_train_state
    from css_tpu_torch.train.train_step import StepConfig, make_train_step

    c, crop, bsz = 21, 512, 8
    cfg = StepConfig(num_classes=c, crop_hw=(crop, crop), scale_range=(0.5, 1.5))
    step = make_train_step(cfg)
    batch = _voc_batch(torch, bsz, crop, c)
    out = {}
    for stride in (16, 8):
        _free(torch)
        model = build_model(c, 256, "resnet101", output_stride=stride, dtype=torch.bfloat16,
                            seed=0)
        if model.backbone.output_stride != stride:
            raise RuntimeError(f"os16: built output stride {model.backbone.output_stride}")
        state = create_train_state(model, c, 256, base_lr=6.4e-3, weight_decay=5e-4,
                                   total_steps=80_000, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        h, w = state.model.output_hw(cfg.crop_hw)

        def one_step():
            return step(state, batch, sample_step_draws(g, cfg, bsz, bsz, 2 * bsz * h * w),
                        1.0)[1]

        out[stride] = _timed_steps(torch, ck, one_step, 1, steps, c, f"os{stride}")
        del state, model
    (ms16, peak16, launches), (ms8, peak8, _) = out[16], out[8]
    print(f"os16 ({smi}): output stride 16 {ms16:.3f} ms/step, peak {peak16:.3f} GiB; output "
          f"stride 8 {ms8:.3f} ms/step, peak {peak8:.3f} GiB (same phase); OS16 / OS8 "
          f"{ms16 / ms8:.4f}x time, {peak16 / peak8:.4f}x peak", flush=True)
    _free(torch)
    return launches


def _alloc_too_much(torch):
    """A real allocator failure: more than the card's whole memory."""
    total = torch.cuda.mem_get_info()[1]
    torch.empty(total + 2**30, dtype=torch.uint8, device="cuda")


class _RecoveryProbe:
    """Wraps the driver's step, eval, checkpoint and recovery functions for
    one run: records the step each attempt starts from, each successful
    attempt's losses, the state, the saves (not written) and the recovery's
    timings; injects allocator failures from inside the attempts numbered
    (from 1) in ``before`` (a forward hook on the student's trunk: an eager
    attempt, before the commit) and ``after`` (after the commit: in
    ``ema_update`` in an eager attempt, before the graphs launch in a
    replay), and into the first eval with ``eval_fault``; with
    ``digest_at``, takes the state's SHA-256 when that attempt and the next
    start.  ``replayed`` counts the attempts that replayed graphs."""

    def __init__(self, torch, before=(), after=(), eval_fault=False, digest_at=None):
        from css_tpu_torch.cli import train_main
        from css_tpu_torch.train import graph_step, train_step

        self.torch, self.tm, self.ts, self.gs = torch, train_main, train_step, graph_step
        self.before, self.after, self.eval_fault = set(before), set(after), eval_fault
        self.digest_at = digest_at
        self.starts, self.losses, self.saves, self.digests, self.faults = [], [], [], [], []
        self.refreshes, self.restores, self.recoveries = [], [], []
        self.state, self.faults_before, self.replayed = None, 0, 0
        self.orig = dict(make_train_step=train_main.make_train_step,
                         make_eval_step=train_main.make_eval_step,
                         save_checkpoint=train_main.save_checkpoint,
                         _recover_and_rerun=train_main._recover_and_rerun,
                         refresh=train_main._HostRecovery.refresh,
                         restore=train_main._HostRecovery.restore,
                         ema_update=train_step.ema_update,
                         replay=graph_step._Replay.__call__)

    def __enter__(self):
        tm, probe, torch = self.tm, self, self.torch
        from css_tpu_torch.train.checkpoint import state_sha256

        def make_train_step(cfg):
            step = probe.orig["make_train_step"](cfg)

            def probed(state, *args):
                probe.starts.append(state.step)
                probe.state = state
                n = len(probe.starts)
                if probe.digest_at is not None and n in (probe.digest_at, probe.digest_at + 1):
                    probe.digests.append(state_sha256(state))
                hook = (state.model.backbone.register_forward_hook(probe._fail_before)
                        if n in probe.before else None)
                replays = REPLAYS[0]
                try:
                    state, metrics = step(state, *args)
                finally:
                    probe.replayed += REPLAYS[0] - replays
                    if hook is not None:
                        hook.remove()
                probe.losses.append({k: v.item() for k, v in metrics.items()})
                return state, metrics
            return probed

        def make_eval_step(model, num_classes, **kw):
            eval_step = probe.orig["make_eval_step"](model, num_classes, **kw)

            def probed(*args):
                if probe.eval_fault:
                    probe.eval_fault = False
                    probe._fail()
                return eval_step(*args)
            return probed

        def ema_update(*args, **kw):
            if len(probe.starts) in probe.after and not torch.cuda.is_current_stream_capturing():
                probe._fail()
            return probe.orig["ema_update"](*args, **kw)

        def replay(captured, *args):
            if len(probe.starts) in probe.after:
                probe._fail()
            return probe.orig["replay"](captured, *args)

        def save_checkpoint(path, state, epoch, miou):
            probe.saves.append((os.path.basename(path), epoch, miou))

        def recover(*args, **kw):
            t0 = time.perf_counter()
            try:
                return probe.orig["_recover_and_rerun"](*args, **kw)
            finally:
                torch.cuda.synchronize()
                probe.recoveries.append(time.perf_counter() - t0)

        def refresh(recovery, state, epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.orig["refresh"](recovery, state, epoch)
            probe.refreshes.append((epoch, time.perf_counter() - t0, recovery.nbytes()))

        def restore(recovery, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = probe.orig["restore"](recovery, state)
            torch.cuda.synchronize()
            probe.restores.append(time.perf_counter() - t0)
            return ok

        tm.make_train_step, tm.make_eval_step = make_train_step, make_eval_step
        tm.save_checkpoint, tm._recover_and_rerun = save_checkpoint, recover
        tm._HostRecovery.refresh, tm._HostRecovery.restore = refresh, restore
        self.ts.ema_update = ema_update
        self.gs._Replay.__call__ = replay
        return self

    def __exit__(self, *exc):
        o, tm = self.orig, self.tm
        tm.make_train_step, tm.make_eval_step = o["make_train_step"], o["make_eval_step"]
        tm.save_checkpoint, tm._recover_and_rerun = o["save_checkpoint"], o["_recover_and_rerun"]
        tm._HostRecovery.refresh, tm._HostRecovery.restore = o["refresh"], o["restore"]
        self.ts.ema_update = o["ema_update"]
        self.gs._Replay.__call__ = o["replay"]

    def _fail_before(self, *hook_args):
        self.faults_before += 1
        self._fail()

    def _fail(self):
        try:
            _alloc_too_much(self.torch)
        except self.torch.cuda.OutOfMemoryError as e:
            self.faults.append(e)
            raise


def _host_state(state) -> list:
    """What ``state_sha256`` hashes, on the host: the student's and the
    teacher's tensors, the momentum buffers and the prototypes."""
    momentum = [state.optimizer.state.get(p, {}).get("momentum_buffer")
                for p in state.model.parameters()]
    tensors = (list(state.model.state_dict().values())
               + list(state.teacher.state_dict().values())
               + [m for m in momentum if m is not None] + [state.prototypes])
    return [t.detach().float().cpu() for t in tensors]


def _max_diff(a: list, b: list) -> str:
    """The largest absolute difference of two host states, with the largest
    magnitude of that tensor in ``b``, and the largest of the differences
    relative to their tensors' largest magnitudes."""
    diffs = [(float((x - y).abs().max()), float(y.abs().max())) for x, y in zip(a, b)]
    d, scale = max(diffs)
    rel = max(d_ / s_ for d_, s_ in diffs if s_ > 0)
    return f"{d:.6g} (in a tensor of largest magnitude {scale:.6g}), relative {rel:.6g}"


def recovery_phase(torch, ck, smi: str):
    """The driver's fault recovery on the card, and ``distributed_init``;
    see the module docstring.  Returns each run's launches."""
    from css_tpu_torch.cli import entries, train_main
    from css_tpu_torch.train.checkpoint import state_sha256

    workdir = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    launches = {}

    def run(label, probe, overrides=None, total_iter=6, expect=None):
        _free(torch)
        config = _voc_yaml(workdir, f"{label}.yaml", **(overrides or {}))
        argv = ["--config", config, "--synthetic", "--job_name", label, "--num_labels", "16",
                "--total_iter", str(total_iter)]
        args = entries.ori_pseudo_parser().parse_args(argv)
        ck.reset_launches()
        t0 = time.perf_counter()
        with probe:
            if expect is None:
                result = train_main.run_training("ori", args)
            else:
                try:
                    train_main.run_training("ori", args)
                except expect as e:
                    result = e
                else:
                    raise RuntimeError(f"recovery {label}: the run did not raise {expect}")
        seconds = time.perf_counter() - t0
        launches[label] = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_finite(probe.losses, f"recovery {label}")
        print(f"recovery {label}: {seconds:.3f} s wall, attempts start at steps {probe.starts}, "
              f"{len(probe.faults)} faults, launches {json.dumps(launches[label])}, peak "
              f"{peak:.3f} GiB, saves {probe.saves}", flush=True)
        return result, peak

    def want_launches(label, probe):
        """One loss's launches for each attempt whose Python reached the
        loss: every attempt less the replayed ones and those failed before
        it."""
        python = len(probe.starts) - probe.replayed - probe.faults_before
        _check_launches(f"recovery {label} ({len(probe.starts)} attempts, {probe.replayed} "
                        f"replayed, {probe.faults_before} failed before the loss)",
                        launches[label], python)

    try:
        # (a), (b) and (a2) under deterministic algorithms: by default the card's
        # runs differ in the last bits (cuDNN's benchmark picks, atomics), and
        # the comparison is of the recovery, not of them
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            probe_a = _RecoveryProbe(torch)
            result_a, peak_a = run("a", probe_a)
            if result_a["steps"] != 6 or probe_a.starts != list(range(6)):
                raise RuntimeError(f"recovery a: {result_a}, attempts {probe_a.starts}")
            want_launches("a", probe_a)
            state_a = _host_state(probe_a.state)
            digest_a = state_sha256(probe_a.state)
            refreshes = probe_a.refreshes
            del probe_a

            probe_b = _RecoveryProbe(torch, before={1}, digest_at=1)
            result_b, peak_b = run("b", probe_b)
            if result_b["steps"] != 6 or probe_b.starts != [0, 0, 1, 2, 3, 4, 5]:
                raise RuntimeError(f"recovery b: {result_b}, attempts {probe_b.starts}")
            if len(probe_b.digests) != 2 or probe_b.digests[0] != probe_b.digests[1]:
                raise RuntimeError(f"recovery b: the retry was given another state than the "
                                   f"failed attempt: {probe_b.digests}")
            want_launches("b", probe_b)
            digest_b = state_sha256(probe_b.state)
            retry_s = probe_b.recoveries
            state_b = None if digest_b == digest_a else _host_state(probe_b.state)
            del probe_b
            if state_b is None:
                print(f"recovery b: final state bit-equal to a's (SHA-256 {digest_b})",
                      flush=True)
            else:
                probe_a2 = _RecoveryProbe(torch)
                run("a2", probe_a2)
                a2_equal = state_sha256(probe_a2.state) == digest_a
                print(f"recovery b: final state NOT bit-equal to a's: largest difference "
                      f"{_max_diff(state_b, state_a)}; a second unfaulted run (a2) differs from "
                      f"a by {_max_diff(_host_state(probe_a2.state), state_a)} (bit-equal: "
                      f"{a2_equal})", flush=True)
                del probe_a2
                if a2_equal:
                    raise RuntimeError("recovery b: two unfaulted runs are bit-equal, the "
                                       "retried one is not")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        if peak_b > peak_a + 1.0:
            raise RuntimeError(f"recovery b: peak {peak_b:.3f} GiB after the OOM and the retry, "
                               f"a's {peak_a:.3f} GiB: the failed attempt's memory was kept")

        probe_c = _RecoveryProbe(torch, after={4})
        result_c, _ = run("c", probe_c)
        if result_c["steps"] != 5 or probe_c.starts != [0, 1, 2, 3, 2, 3, 4]:
            raise RuntimeError(f"recovery c: {result_c}, attempts {probe_c.starts}")
        if probe_c.replayed < 4:
            raise RuntimeError(f"recovery c: {probe_c.replayed} attempts replayed, want 4 or more")
        want_launches("c", probe_c)
        restore_s, restore_rerun_s = probe_c.restores, probe_c.recoveries
        del probe_c

        probe_d = _RecoveryProbe(torch, before=range(1, 100))
        err, _ = run("d", probe_d, expect=torch.cuda.OutOfMemoryError)
        chain, e = [], err
        while e is not None:
            chain.append(e)
            e = e.__context__
        if probe_d.starts != [0, 0, 0] or err is not probe_d.faults[-1] \
                or probe_d.faults[0] not in chain:
            raise RuntimeError(f"recovery d: attempts {probe_d.starts}; {len(chain)} errors in "
                               f"the chain, the first fault among them: "
                               f"{probe_d.faults[0] in chain}")
        want_launches("d", probe_d)
        print(f"recovery d: propagated {type(err).__name__}: {str(err).splitlines()[0]}",
              flush=True)
        del err, chain, e, probe_d

        probe_e = _RecoveryProbe(torch, after={4})
        err, _ = run("e", probe_e, overrides={"Training_Setting.host_recovery": 0},
                        expect=RuntimeError)
        if ("Training_Setting.host_recovery" not in str(err)
                or not isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
                or probe_e.starts != [0, 1, 2, 3]):
            raise RuntimeError(f"recovery e: {err!r}, attempts {probe_e.starts}")
        want_launches("e", probe_e)
        print(f"recovery e: raised {str(err)[:160]}", flush=True)
        del err, probe_e

        probe_f = _RecoveryProbe(torch, eval_fault=True)
        result_f, _ = run("f", probe_f, total_iter=4)
        log = open(os.path.join(workdir, "checkpoints", "f", "train.log")).read()
        saves = [s[:2] for s in probe_f.saves]
        if (result_f["steps"] != 4 or "WARNING eval failed (OutOfMemoryError" not in log
                or "Epoch:0 * mIoU -1.0000" not in log or ("best_model", 1) in saves
                or ("last_model", 1) not in saves
                or [r[0] for r in probe_f.refreshes] != [0, 0, 1]):
            raise RuntimeError(f"recovery f: {result_f}, saves {saves}, refreshes "
                               f"{probe_f.refreshes}")
        want_launches("f", probe_f)
        del probe_f

        print(f"recovery ({smi}): refreshes of a (epoch, s, GiB) "
              f"{[(e, round(t, 4), round(n / 2**30, 4)) for e, t, n in refreshes]} (the first, "
              f"before any momentum, allocates the pinned buffers); "
              f"retry (b) {[round(t, 4) for t in retry_s]} s wall (the rerun step included); "
              f"restore (c) {[round(t, 4) for t in restore_s]} s, restore + rerun "
              f"{[round(t, 4) for t in restore_rerun_s]} s; peak a {peak_a:.3f} GiB, b (after "
              f"the OOM and the retry) {peak_b:.3f} GiB", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free(torch)
    _rendezvous_check(torch)
    return launches


def _rendezvous_check(torch):
    """(g) of the recovery phase: ``distributed_init`` through
    ``COORDINATOR_ADDRESS`` with one process: a 1-rank NCCL group and one
    all-reduce."""
    import socket

    from css_tpu_torch import parallel

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    saved = os.environ.get("COORDINATOR_ADDRESS")
    os.environ["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        device = parallel.distributed_init(num_processes=1, process_id=0)
        try:
            t = torch.full((4,), 2.5, device=device)
            torch.distributed.all_reduce(t)
            backend = torch.distributed.get_backend()
            ok = bool((t == 2.5).all()) and backend == "nccl" and parallel.world_size() == 1
        finally:
            torch.distributed.destroy_process_group()
        seconds = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["COORDINATOR_ADDRESS"]
        else:
            os.environ["COORDINATOR_ADDRESS"] = saved
    if not ok or device != torch.device("cuda:0"):
        raise RuntimeError(f"recovery g: distributed_init gave {device}, backend {backend}, "
                           f"all-reduce {t.tolist()}")
    print(f"recovery g: distributed_init through COORDINATOR_ADDRESS joined a 1-rank {backend} "
          f"group on {device} and all-reduced, {seconds:.3f} s", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3, help="timed train steps (>= 3)")
    args = parser.parse_args()
    if args.steps < 3:
        parser.error("--steps must be at least 3")
    # deterministic cuBLAS for _graph_vs_eager: read when the first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from css_tpu_torch.ops.kernels import _build
    from css_tpu_torch.ops.kernels import contrastive_kernels as ck

    _watch_step_graphs(torch)
    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for source, log in _build.build_logs.items():
        print(f"--- nvcc {source}\n{log.strip()}", flush=True)

    clock = [time.perf_counter()]

    def phase_done(name):
        clock.append(time.perf_counter())
        print(f"phase {name}: {clock[-1] - clock[-2]:.1f} s", flush=True)

    kernels, city_kernels = kernel_phase(torch, ck)
    phase_done("kernels")
    batchnorm = batchnorm_phase(torch)
    phase_done("batchnorm")
    contrastive_phase(torch, ck)
    launches, train = train_phase(torch, ck, args.steps)
    train_ms = train["ms"]
    phase_done("contrastive + train")
    strategies_phase(torch, ck, train, args.steps)
    phase_done("strategies")
    dense_launches, dense_rows = optin_steps_phase(torch, ck, train, smi, args.steps)
    phase_done("opt-in steps")
    del train
    cross_entry_phase(torch, ck)
    phase_done("cross entry point")
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        checkpoint = os.path.join(keep, "driver_last_model")
        driver_phase(torch, ck, smi, checkpoint)
        phase_done("driver")
        optin_entry_phase(torch, smi, checkpoint)
        phase_done("opt-in entry points")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    city_launches = cityscapes_phase(torch, ck, smi, args.steps)
    phase_done("cityscapes")
    segformer_launches = segformer_phase(torch, ck, smi, args.steps)
    phase_done("segformer")
    dist_launches, rank_launches = distributed_phase(torch, ck, smi, args.steps, train_ms)
    phase_done("distributed")
    keep = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        import_launches, imported = import_phase(torch, ck, smi, keep)
        phase_done("import")
        files_launches, root = files_phase(torch, ck, smi, keep)
        phase_done("files")
        evaluate_ranks_phase(torch, smi, keep, imported, root)
        phase_done("evaluate-ranks")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    os16_launches = os16_phase(torch, ck, smi, args.steps)
    phase_done("os16")
    recovery_launches = recovery_phase(torch, ck, smi)
    phase_done("recovery")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build on", flush=True)

    source = "css_tpu_torch/csrc/" + ck.SOURCE
    tpu = "css_tpu/ops/pallas/contrastive_kernels.py"
    rows = []
    # live_rows_compact (one weight vector) launches 0 times on every step path
    # since class_live_rows compacts every class at once; its timings stay
    for name, key, line_no in (("weighted_exp_softsum_fwd", "k1", 35),
                               ("weighted_exp_softsum_bwd", "k2", 60),
                               ("class_live_rows", "class", 155),
                               ("live_rows_compact", "compact", 155)):
        # the VOC train phase's row; the Cityscapes table's beside it
        city = dict(city_kernels[key], n=N_CITY, launches=city_launches[name])
        # the distributed phase's paths: the 1-rank NCCL steps, each rank's run
        dist = dict(world_1_launches=dist_launches[name],
                    rank_launches=[r[name] for r in rank_launches])
        # the expected_pallas steps' launches and the dense weights' timings
        dense = dict(dense_rows[key], launches=dense_launches[name])
        # the new paths' steps: the imported checkpoint resumed, the real files, OS16,
        # SegFormer
        paths = dict(imported_resume_launches=import_launches[name],
                     files_launches=files_launches[name], os16_launches=os16_launches[name],
                     segformer_launches=segformer_launches[name],
                     # the recovery runs: per attempt that reached the loss
                     recovery_launches={run: n[name] for run, n in recovery_launches.items()})
        rows.append(dict(name=name, route="cuda", source=source, replaces=f"{tpu}:{line_no}",
                         launches=launches[name], **kernels[key], cityscapes=city,
                         distributed=dist, expected_pallas=dense, **paths))
    line = {"kernels": rows, "batchnorm": batchnorm, "batchnorm_steps": BN_STEP_LAUNCHES}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
