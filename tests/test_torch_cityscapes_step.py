"""The Cityscapes recipe's train step in the port against css_tpu's, on the
CPU, at test scale: the deep-stem ``tiny_stem`` trunk with remat, OHEM CE,
the fused labeled + unlabeled student pass and, for ``mix``, the fused
teacher pass.  Same weights (through ``from_jax_variables``), batch and draws
(replayed from the JAX key chain) as ``tests/test_torch_train_step.py``.
Then the port's fused step against its own two-pass step.

OHEM keeps ``ohem_min_kept_per_image`` = 64, 128 of the ~1,500 valid labeled
pixels: at the recipe's threshold 0.7 the threshold decides (random-init
probabilities are far below it), at 0.05 the k-th value does.

Tolerances, calibrated as in ``tests/test_torch_train_step.py`` against
JAX's own spread when its initial parameters are multiplied by (1 + 1e-6).
One step: losses to rtol 2e-3 (measured 3.4e-5), parameters to atol 5e-4
(2.8e-5), BN stats and prototypes to atol 2e-3 (9.1e-5, 2.1e-5).  ``mix``
weights its unsupervised loss by its few agreeing pixels, so one step moves
a parameter by up to 1.7: parameters are held to 5% of JAX's largest update
(measured 0.06%; JAX's own 0.57%).  Along the 3-step ``ori``
trajectory step 1 keeps the loss tolerance (measured 5.9e-5; JAX's own
4.2e-3) with parameters to 2e-2 (1.5e-3) and BN stats to 5e-2 (2.9e-3); at
step 2 the unsupervised loss, taken over the few confident pixels, spreads
by 3.0% in JAX against itself, so the losses are held to rtol 6e-2
(measured 2.3%).  The port's fused step against its two-pass step differs
only in the order of f32 sums in the BN statistics, which the deep BN chain
amplifies in the stem's weight gradients: losses to rtol 1e-4 (measured
2.5e-5), parameters to 2% of the step's largest update (0.52-0.69%), BN
stats and prototypes to atol 1e-3 (3.8e-4, 9.5e-7).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import css_tpu.train.train_step as jax_train_step
from css_tpu.models import build_model as jax_build_model
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu_torch.losses import cross_entropy as tce
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train import train_step as torch_train_step
from css_tpu_torch.train.draws import sample_step_draws
from css_tpu_torch.train.state import create_train_state
from tests.test_torch_train_step import (B, C, CFG, CROP, D, LIVE_UNSUP, LOSS_RTOL, OPT,
                                         PARAM_ATOL, STAT_ATOL, STEP1_PARAM_ATOL,
                                         STEP1_STAT_ATOL, _assert_losses, _assert_tree, _batch,
                                         replay_step_draws)

UPDATE_RTOL = 5e-2
STEP2_LOSS_RTOL = 6e-2
FUSED_LOSS_RTOL, FUSED_ATOL, FUSED_UPDATE_RTOL = 1e-4, 1e-3, 2e-2

CITY = dict(CFG, **LIVE_UNSUP, sup_loss="ohem", ohem_min_kept_per_image=64, fused_forward=True)
KTH_WINS = 0.05
BACKBONE = "tiny_stem"


class _JaxSide:
    """The tiny deep-stem JAX model (remat on), its initial state, and one
    compiled step per step config."""

    def __init__(self):
        self.model = jax_build_model(num_classes=C, output_dim=D, backbone=BACKBONE, remat=True)
        self.tx = make_optimizer(**OPT)
        self.state0 = jax.jit(lambda key: jax_create_state(
            key, self.model, self.tx, (1, CROP, CROP, 3), num_classes=C, output_dim=D))(
                jax.random.key(0))
        self.steps = {}

    def step(self, cfg, state, batch, key):
        if cfg not in self.steps:
            self.steps[cfg] = jax.jit(jax_train_step.make_train_step(self.model, self.tx, cfg))
        return self.steps[cfg](state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                               jnp.float32(1.0), jnp.asarray(False))


@pytest.fixture(scope="module")
def jax_side():
    return _JaxSide()


def _port_state(params, batch_stats):
    model = build_model(C, D, BACKBONE, remat=True)
    model.load_state_dict(from_jax_variables(params, batch_stats), strict=True)
    return create_train_state(model, C, D, **OPT, device="cpu")


def _run(jax_side, monkeypatch, n_steps, seed, **overrides):
    """Both steps ``n_steps`` times from the same state; yields (jax
    metrics, jax state, port metrics, port state, JAX's largest parameter
    update, the port's OHEM keep threshold) after each step."""
    cfg = dict(CITY, **overrides)
    jcfg = jax_train_step.StepConfig(**cfg)
    tstep = torch_train_step.make_train_step(torch_train_step.StepConfig(**cfg))
    thresholds = []
    real = tce.ohem_keep_threshold
    monkeypatch.setattr(tce, "ohem_keep_threshold",
                        lambda *a: thresholds.append(real(*a)) or thresholds[-1])
    jstate = jax_side.state0
    tstate = _port_state(jstate.params, jstate.batch_stats)
    key = jax.random.key(1)
    for i in range(n_steps):
        batch = _batch(seed + i)
        before = jstate.params
        jstate, jm = jax_side.step(jcfg, jstate, batch, key)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                           replay_step_draws(key, i, jcfg, B, B, deep_stem=True), 1.0)
        update = max(float(jnp.abs(a - b).max())
                     for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(before)))
        yield jm, jstate, tm, tstate, update, float(thresholds[-1])


def _assert_close_step(jm, jstate, tm, tstate, param_atol, stat_atol=STAT_ATOL,
                       loss_rtol=LOSS_RTOL):
    """Losses, student and teacher parameters and BN stats, and prototypes."""
    _assert_losses(jm, tm, rtol=loss_rtol)
    assert tstate.step == int(jstate.step)
    _assert_tree(tstate.model, jstate.params, jstate.batch_stats, param_atol, stat_atol)
    _assert_tree(tstate.teacher, jstate.ema_params, jstate.ema_batch_stats, param_atol,
                 stat_atol)
    np.testing.assert_allclose(tstate.prototypes.numpy(), np.asarray(jstate.prototypes),
                               rtol=0, atol=STAT_ATOL)


def test_ori_cityscapes_step_matches_jax(jax_side, monkeypatch):
    ((jm, jstate, tm, tstate, _, keep),) = list(_run(jax_side, monkeypatch, 1, seed=40))
    assert keep == np.float32(0.7)          # the recipe's threshold decides
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    _assert_close_step(jm, jstate, tm, tstate, PARAM_ATOL)


def test_ori_cityscapes_three_step_trajectory_matches_jax(jax_side, monkeypatch):
    run = _run(jax_side, monkeypatch, 3, seed=40)
    jm, jstate, tm, tstate, _, _ = next(run)
    _assert_close_step(jm, jstate, tm, tstate, PARAM_ATOL)
    jm, jstate, tm, tstate, _, _ = next(run)
    _assert_close_step(jm, jstate, tm, tstate, STEP1_PARAM_ATOL, STEP1_STAT_ATOL)
    jm, jstate, tm, tstate, _, _ = next(run)
    assert tstate.step == int(jstate.step) == 3
    _assert_losses(jm, tm, rtol=STEP2_LOSS_RTOL)


def test_mix_fused_teacher_step_matches_jax(jax_side, monkeypatch):
    """``mix`` with the fused teacher and student passes, OHEM's threshold
    set by its k-th value; the teacher's BN stats (advanced labeled first
    inside the grouped pass) are held against JAX's."""
    ((jm, jstate, tm, tstate, update, keep),) = list(
        _run(jax_side, monkeypatch, 1, seed=40, strategy="mix", ohem_thresh=KTH_WINS))
    assert keep > KTH_WINS                  # the 128th smallest target probability
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    _assert_close_step(jm, jstate, tm, tstate, UPDATE_RTOL * update)


@pytest.mark.parametrize("strategy", ["ori", "mix", "cross"])
def test_port_fused_step_equals_two_pass_step(strategy):
    """One step from the same state with the same draws: the fused passes
    give the two-pass step's losses, parameters, BN stats (student and
    teacher) and prototypes."""
    torch.manual_seed(0)
    base = create_train_state(build_model(C, D, BACKBONE, remat=True, seed=3), C, D, **OPT,
                              device="cpu")
    base.prototypes = torch.randn(C, D)
    cfg = dict(CITY, strategy=strategy, ohem_thresh=KTH_WINS)
    draws = sample_step_draws(torch.Generator().manual_seed(5),
                              torch_train_step.StepConfig(**cfg), B, B, 2 * B * 9 * 9)
    batch = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
    before = [p.detach().clone() for p in base.model.parameters()]
    out = {}
    for fused in (False, True):
        state = copy.deepcopy(base)
        step = torch_train_step.make_train_step(
            torch_train_step.StepConfig(**dict(cfg, fused_forward=fused)))
        out[fused] = step(state, batch, draws, 1.0, True)
    (two, m_two), (one, m_one) = out[False], out[True]
    for name in ("sup", "unsup", "contrast", "total"):
        np.testing.assert_allclose(float(m_one[name]), float(m_two[name]), rtol=FUSED_LOSS_RTOL,
                                   atol=1e-6, err_msg=name)
    update = max(float((p.detach() - q).abs().max())
                 for p, q in zip(two.model.parameters(), before))
    for a, b in ((one.model, two.model), (one.teacher, two.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        for key in sa:
            stat = key.endswith(("running_mean", "running_var"))
            np.testing.assert_allclose(sa[key].numpy(), sb[key].numpy(), rtol=0,
                                       atol=FUSED_ATOL if stat else FUSED_UPDATE_RTOL * update,
                                       err_msg=key)
    np.testing.assert_allclose(one.prototypes.numpy(), two.prototypes.numpy(), rtol=0,
                               atol=FUSED_ATOL)
    moved = base.teacher.state_dict()["backbone.stem1.bn.running_mean"]
    assert not torch.equal(one.teacher.state_dict()["backbone.stem1.bn.running_mean"], moved)


def test_step_refuses_draws_sized_for_another_output():
    """The deep stem's output at 32 is 9 x 9; draws sized for the plain
    stem's 8 x 8 are refused, not silently misread."""
    state = create_train_state(build_model(C, D, BACKBONE), C, D, **OPT, device="cpu")
    cfg = torch_train_step.StepConfig(**CITY)
    draws = sample_step_draws(torch.Generator().manual_seed(0), cfg, B, B, 2 * B * 8 * 8)
    with pytest.raises(ValueError, match=r"the model's 2\+2 outputs at \(9, 9\)"):
        torch_train_step.make_train_step(cfg)(
            state, {k: torch.from_numpy(v) for k, v in _batch(0).items()}, draws, 1.0)
