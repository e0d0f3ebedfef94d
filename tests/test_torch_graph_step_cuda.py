"""The train step replayed as CUDA graphs (``train/graph_step.py``) on the
card, against the same step run eagerly.  Marked ``gpu``; they skip without
a card:

    python -m pytest --noconftest tests/test_torch_graph_step_cuda.py -m gpu -q

Each comparison runs one trajectory twice from the same weights, batches and
draws: as the step runs (its first call eager, then a capture and replays)
and with the capture held off (``StepGraphs.prepare`` patched to return
None), both under deterministic algorithms and cuDNN's deterministic picks, so that two
eager runs agree bit for bit.  The trunks are the test trunks of the three
configurations: the plain-stem ``tiny`` (VOC's recipe), the deep-stem
``tiny_stem`` with the fused forward and OHEM (Cityscapes'), and SegFormer's
``mit_tiny``; all in bf16.  The SGD and EMA updates on the step's device
scalars are held against ``torch.optim.SGD`` and the Python-number EMA.
"""

from __future__ import annotations

import gc
import os
import warnings

# deterministic cuBLAS: read when the first cuBLAS handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from css_tpu_torch.losses import contrastive  # noqa: E402
from css_tpu_torch.models.deeplabv3 import build_model  # noqa: E402
from css_tpu_torch.ops.kernels import batchnorm_kernels as bk  # noqa: E402
from css_tpu_torch.ops.kernels import contrastive_kernels as ck  # noqa: E402
from css_tpu_torch.train import graph_step  # noqa: E402
from css_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from css_tpu_torch.train.draws import sample_step_draws  # noqa: E402
from css_tpu_torch.train.schedulers import poly_lr, teacher_ema_decay  # noqa: E402
from css_tpu_torch.train.state import create_train_state, ema_update, sgd_step  # noqa: E402
from css_tpu_torch.train.train_step import StepConfig, make_train_step  # noqa: E402
from css_tpu_torch.utils.profiling import reset, snapshot, tracing  # noqa: E402

D, B, CROP = 16, 2, 64
TRUNKS = {
    "voc": ("tiny", dict(num_classes=6)),
    "city": ("tiny_stem", dict(num_classes=19, sup_loss="ohem", ohem_min_kept_per_image=64,
                               fused_forward=True)),
    "segformer": ("mit_tiny", dict(num_classes=6)),
    "cross": ("tiny", dict(num_classes=6, strategy="cross", strong_threshold=0.8)),
    **{mode: ("tiny", dict(num_classes=6, negative_mode=mode))
       for mode in ("expected", "expected_pallas", "sampled")},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(flags[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]


class Run:
    """One trajectory of a trunk's step: state, step function, its batches
    (uint8 canvases larger than the crop) and draws by step number."""

    def __init__(self, trunk: str, contrast_weight: float = 1.0):
        backbone, kw = TRUNKS[trunk]
        self.cfg = StepConfig(crop_hw=(CROP, CROP), scale_range=(0.5, 1.5), num_queries=8,
                              num_negatives=16, **kw)
        c = self.cfg.num_classes
        model = build_model(c, D, backbone, dtype=torch.bfloat16, seed=0)
        self.state = create_train_state(model, c, D, base_lr=1e-2, weight_decay=5e-4,
                                        total_steps=100, device="cuda")
        self.step_fn = make_train_step(self.cfg)
        h, w = self.state.model.output_hw(self.cfg.crop_hw)
        self.rows = 2 * B * h * w
        self.weight = contrast_weight
        self.losses, self.batches = [], {}

    def batch(self, i: int) -> dict:
        if i not in self.batches:
            self.batches[i] = self._make_batch(i)
        return self.batches[i]

    def _make_batch(self, i: int) -> dict:
        rng = np.random.default_rng(i)
        canvas = (CROP + 16, CROP + 24)
        c = self.cfg.num_classes
        out = {"l_image": rng.integers(0, 256, (B, *canvas, 3), np.uint8),
               "l_label": rng.integers(0, c, (B, *canvas), np.int32),
               "l_valid_hw": np.array([canvas] * B, np.int32),
               "u_image": rng.integers(0, 256, (B, *canvas, 3), np.uint8),
               "u_valid_hw": np.array([canvas] * B, np.int32)}
        return {k: torch.from_numpy(v).cuda() for k, v in out.items()}

    def step(self, use_rep_labels: bool = False):
        i = self.state.step
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        draws = sample_step_draws(g, self.cfg, B, B, self.rows)
        self.state, metrics = self.step_fn(self.state, self.batch(i), draws, self.weight,
                                           use_rep_labels)
        self.losses.append(torch.stack([metrics[k] for k in ("total", "sup", "unsup",
                                                              "contrast")]))
        return metrics

    def tensors(self) -> dict:
        s = self.state
        out = {f"student.{k}": v for k, v in s.model.state_dict().items()}
        out.update({f"teacher.{k}": v for k, v in s.teacher.state_dict().items()})
        out.update({f"momentum.{k}": s.optimizer.state[p]["momentum_buffer"]
                    for k, p in s.model.named_parameters()})
        out["prototypes"] = s.prototypes
        out.update({f"loss.{i}": v for i, v in enumerate(self.losses)})
        return out

    @property
    def graphs(self):
        return self.step_fn.graphs


def _eager(monkeypatch):
    monkeypatch.setattr(graph_step.StepGraphs, "prepare", lambda self, *args: None)


def _assert_bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"{len(bad)} of {len(want)} tensors differ, first {bad[:5]}"


def _trajectory(trunk, uses, monkeypatch, eager=False, weight=1.0, between=None):
    with monkeypatch.context() as m:
        if eager:
            _eager(m)
        run = Run(trunk, weight)
        for i, use in enumerate(uses):
            if between is not None:
                between(i, run)
            run.step(use)
        torch.cuda.synchronize()
        return run


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", ["voc", "city", "segformer"])
def test_graph_steps_equal_eager_steps(card, trunk, monkeypatch):
    ck.reset_launches()
    bk.reset_launches()
    graphed = _trajectory(trunk, [False] * 4, monkeypatch)
    launches = (dict(ck.LAUNCHES), dict(bk.LAUNCHES))
    assert (graphed.graphs.captures, graphed.graphs.replays) == (1, 3)
    ck.reset_launches()
    bk.reset_launches()
    eager = _trajectory(trunk, [False] * 4, monkeypatch, eager=True)
    assert eager.graphs.captures == 0
    _assert_bit_equal(graphed.tensors(), eager.tensors())
    # the counters count the wrappers' calls: the eager step's and the
    # capture's, none in a replay (the replayed kernels are the graphs'; the
    # bit-equal state is their witness)
    assert launches == tuple({k: n // 2 for k, n in c.items()} for c in (ck.LAUNCHES, bk.LAUNCHES))
    assert launches[0]["class_live_rows"] == 2 and launches[1]["css_bn_stats"] > 0


@pytest.mark.gpu
def test_cross_with_use_rep_labels_flipping(card, monkeypatch):
    uses = [False, True] * 3          # a key each; each eager once, then replayed twice
    graphed = _trajectory("cross", uses, monkeypatch, weight=0.75)
    assert (graphed.graphs.captures, graphed.graphs.replays) == (2, 4)
    eager = _trajectory("cross", uses, monkeypatch, eager=True, weight=0.75)
    _assert_bit_equal(graphed.tensors(), eager.tensors())


@pytest.mark.gpu
def test_replays_never_synchronise(card, monkeypatch):
    run = Run("voc")
    run.step()
    run.step()                     # the capture
    for i in range(2, 5):          # a copy from the host's pageable memory synchronises
        run.batch(i)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            run.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert run.graphs.replays == 4


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", ["voc", "segformer"])
def test_spans_time_the_replayed_phases(card, trunk, monkeypatch):
    run = Run(trunk)
    run.step()
    run.step()
    torch.cuda.synchronize()
    reset()
    try:
        with tracing():
            for _ in range(2):
                run.step()
        spans = snapshot()
    finally:
        reset()
    assert spans["css.step"]["count"] == spans["css.graph"]["count"] == 2
    assert spans["css.augment"]["count"] == 4
    phases = ["css.augment", "css.teacher", "css.student", "css.losses", "css.backward",
              "css.update"] + (["css.encoder", "css.decoder"] if trunk == "segformer" else [])
    assert all(spans[p]["device_ms"] > 0 and spans[p]["syncs"] == 0 for p in phases), spans
    assert spans["css.augment"]["parent"] == "css.graph"
    inside = sum(spans[p]["device_ms"] for p in phases[:6])
    assert inside <= spans["css.graph"]["device_ms"] + 0.01      # event stamps: 0.5 us


def _restore_after_two(tmp_path):
    path = str(tmp_path / "ckpt")

    def between(i, run):
        if i == 2:
            save_checkpoint(path, run.state, 0, 0.0)
        if i == 3:
            run.state, _, _ = restore_checkpoint(path, run.state)
    return between


@pytest.mark.gpu
def test_restore_checkpoint_recaptures(card, monkeypatch, tmp_path):
    graphed = _trajectory("voc", [False] * 5, monkeypatch, between=_restore_after_two(tmp_path))
    assert graphed.graphs.captures == 2       # the momentum and the prototypes moved
    eager = _trajectory("voc", [False] * 5, monkeypatch, eager=True,
                        between=_restore_after_two(tmp_path))
    _assert_bit_equal(graphed.tensors(), eager.tensors())


@pytest.mark.gpu
def test_host_recovery_copy_back(card, monkeypatch):
    from css_tpu_torch.cli.train_main import _HostRecovery

    def between(i, run):
        if i == 2:
            run.recovery = _HostRecovery(1)
            run.recovery.refresh(run.state, 0)
        if i == 3:
            assert run.recovery.restore(run.state)

    graphed = _trajectory("voc", [False] * 5, monkeypatch, between=between)
    eager = _trajectory("voc", [False] * 5, monkeypatch, eager=True, between=between)
    assert graphed.state.step == 4 and graphed.graphs.replays >= 3
    _assert_bit_equal(graphed.tensors(), eager.tensors())


@pytest.mark.gpu
def test_a_syncing_op_keeps_the_step_eager(card, monkeypatch):
    real = contrastive.class_live_rows

    def syncing(p_over_cnt, masked_cls, g, u=None):
        idx, wv, n_live = real(p_over_cnt, masked_cls, g, u)
        assert int(n_live.sum()) >= 0          # a read-back: a capture refuses it
        return idx, wv, n_live

    monkeypatch.setattr(contrastive, "class_live_rows", syncing)
    with pytest.warns(RuntimeWarning, match="capture failed") as caught:
        graphed = _trajectory("voc", [False] * 4, monkeypatch)
    assert len([w for w in caught if "capture failed" in str(w.message)]) == 1
    assert graphed.graphs.failed is not None and graphed.graphs.captures == 0
    torch.randn(4, device="cuda")      # the generators left the capture with it
    assert torch.cuda.get_sync_debug_mode() == 0
    eager = _trajectory("voc", [False] * 4, monkeypatch, eager=True)
    _assert_bit_equal(graphed.tensors(), eager.tensors())


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of f32 numbers at ``|x|``."""
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


def _params(seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    shapes = [(1024, 256, 1, 1), (256, 256, 3, 3), (21, 256), (256,), (1,)]
    return [torch.nn.Parameter(torch.randn(s, generator=g).cuda()) for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_step_within_one_ulp_of_torch_sgd(card, nesterov):
    """Each of four steps from the same parameters and momentum: the momentum
    bit-equal to ``torch.optim.SGD``'s, the parameters within one unit in the
    last place of the larger of the result and the product lr * d (the
    update ``sgd_step`` rounds before its add, where SGD's add fuses it)."""
    mine = _params(0)
    kw = dict(lr=1.0, momentum=0.9, weight_decay=5e-4, nesterov=nesterov)
    opt = torch.optim.SGD(mine, **kw)
    g = torch.Generator().manual_seed(1)
    lr_t = torch.zeros((), device="cuda")
    for k in range(4):
        theirs = [torch.nn.Parameter(p.detach().clone()) for p in mine]
        ref = torch.optim.SGD(theirs, **kw)
        for a, b in zip(mine, theirs):
            a.grad = torch.randn(a.shape, generator=g).cuda()
            b.grad = a.grad.clone()
            if k:
                ref.state[b]["momentum_buffer"] = opt.state[a]["momentum_buffer"].clone()
        lr = poly_lr(k * 20_000, 6.4e-3, 80_000)
        for group in ref.param_groups:
            group["lr"] = lr
        before = [p.detach().clone() for p in mine]
        lr_t.fill_(lr)
        sgd_step(opt, lr_t)
        ref.step()
        for a, b, p0 in zip(mine, theirs, before):
            assert torch.equal(opt.state[a]["momentum_buffer"], ref.state[b]["momentum_buffer"])
            step = (p0 - b.detach()).abs()          # lr * d, as SGD applied it
            tol = torch.maximum(_ulp(b.detach()), _ulp(step))
            assert bool(((a.detach() - b.detach()).abs() <= tol).all()), k


@pytest.mark.gpu
def test_ema_update_within_one_ulp_of_the_python_number_law(card):
    """Steps 0, 1, 99 and 100 of the teacher's EMA, each from the same
    teacher: within one unit in the last place of the larger of the result
    and the product (1 - decay) * student, the one that ``ema_update``
    rounds before its add."""
    teacher, student = _params(2), _params(3)
    decay_t, rest_t = torch.zeros((), device="cuda"), torch.zeros((), device="cuda")
    for k in (0, 1, 99, 100):
        with torch.no_grad():
            for p in student:
                p.add_(torch.randn_like(p), alpha=0.01)
        decay = teacher_ema_decay(k, 0.99)
        want = [t.detach().clone() for t in teacher]
        torch._foreach_mul_(want, decay)
        torch._foreach_add_(want, [p.detach() for p in student], alpha=1.0 - decay)
        decay_t.fill_(decay)
        rest_t.fill_(1.0 - decay)
        wrapped = torch.nn.ParameterList(teacher), torch.nn.ParameterList(student)
        ema_update(*wrapped, decay_t, rest_t)
        for a, b, p in zip(teacher, want, student):
            tol = torch.maximum(_ulp(b), _ulp(p.detach() * (1.0 - decay)))
            assert bool(((a.detach() - b).abs() <= tol).all()), k


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["expected", "expected_pallas", "sampled"])
def test_opt_in_modes_replay_or_give_their_capture_back(card, mode, monkeypatch):
    """The opt-in negative modes either replay or, where CUDA refuses their
    capture, stay eager; either way they equal their eager run bit for bit,
    and a refused capture gives its memory back: a second trajectory leaves
    no more reserved beyond the live tensors than the first."""
    kept = []
    for _ in range(2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)      # a refused capture's
            graphed = _trajectory(mode, [False] * 4, monkeypatch)
        eager = _trajectory(mode, [False] * 4, monkeypatch, eager=True)
        _assert_bit_equal(graphed.tensors(), eager.tensors())
        assert graphed.graphs.captures == 1 or graphed.graphs.failed is not None
        del graphed, eager
        gc.collect()
        torch.cuda.empty_cache()
        kept.append(torch.cuda.memory_reserved() - torch.cuda.memory_allocated())
    assert kept[1] <= kept[0] + 2**21, kept
