"""The port's ``ori`` train step (css_tpu_torch/train) against css_tpu's, on
the tiny trunk: same weights (through ``from_jax_variables``), same batch,
and the same random draws, replayed from the JAX step's key chain
(train_step.py:230-233,148,201; augment.py:245,285; photometric.py:213-217,
403-408; mixing.py:44-49,121; contrastive.py:186,224,305;
contrastive_kernels.py:126).  Both sides run in f32 on the CPU; the JAX
contrastive loss takes its dense route, the port its plain K1/K2.

Tolerances.  The geometric resample rounds its operands to bf16 on both
sides, so a pixel can land one bf16 step apart, and the tiny trunk's
train-mode step at batch 2 is ill-conditioned: the ASPP pool BN normalizes
n = 2 values, and multiplying JAX's own input images by (1 + 1e-6) moves
its step-0 gradients by up to 5% of their largest entry, its step-0
parameters by 5.5e-3 and BN stats by 2.9e-3, and its step-2 losses by
1.4%.  Measured against that: after one step the port's losses agree to
rtol 2e-3 (measured 3e-5), parameters to atol 5e-4 (measured 1.1e-4), BN
stats and prototypes to atol 2e-3 (measured 1.6e-4).  Along the 3-step
trajectory the step-0 difference is amplified at each step.  Step 1 keeps
the loss and prototype tolerances (measured 5e-5 and 6e-5), and holds the
parameters to atol 2e-2 (measured 7.0e-3; JAX's own spread 2.6e-2) and the
BN stats to atol 5e-2 (measured 1.9e-2; JAX's own 0.41).  At step 2 the
losses are held to rtol 3e-2 (measured 1.0%, inside JAX's own 1.4%).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.models import build_model as jax_build_model
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu.train.train_step import StepConfig as JaxStepConfig
from css_tpu.train.train_step import make_train_step as jax_make_step
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train.draws import StepDraws
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.models.resnet import resnet_tiny
from css_tpu_torch.train.train_step import StepConfig, make_train_step
from tests.test_torch_augment import replay_batch_transform, replay_mix
from tests.test_torch_losses import replay_contrast

C, D, CROP, B = 6, 16, 32, 2
SCALE = (0.5, 1.5)
CFG = dict(num_classes=C, crop_hw=(CROP, CROP), scale_range=SCALE, num_queries=8,
           num_negatives=16)
# thresholds low enough that a random-init teacher clears them, so the
# unsupervised loss and the unlabeled half of the contrastive loss are live
LIVE_UNSUP = dict(un_threshold=0.3, weak_threshold=0.25)
OPT = dict(base_lr=1e-2, weight_decay=5e-4, total_steps=100)

LOSS_RTOL = 2e-3
LATE_LOSS_RTOL = 3e-2
PARAM_ATOL = 5e-4
STAT_ATOL = 2e-3
STEP1_PARAM_ATOL = 2e-2
STEP1_STAT_ATOL = 5e-2


def replay_step_draws(rng, step, cfg: JaxStepConfig, bl, bu, deep_stem=False,
                      rank=None) -> StepDraws:
    """The draws of css_tpu's ``step(state, batch, rng, ...)`` at ``step``,
    for the tiny trunk's output size (plain or deep stem); with ``rank``,
    those of device ``rank`` of the step built with an ``axis_name``."""
    rng = jax.random.fold_in(rng, step)
    if rank is not None:
        rng = jax.random.fold_in(rng, rank)
    k_laug, k_ucrop, k_teacher, k_contrast = jax.random.split(rng, 4)
    k_t, k_mix, k_aug2 = jax.random.split(k_teacher, 3)
    h, w = resnet_tiny(deep_stem=deep_stem).low_level_hw(cfg.crop_hw)
    return StepDraws(
        l_aug=replay_batch_transform(k_laug, bl, cfg.scale_range, True),
        u_crop=replay_batch_transform(k_ucrop, bu, (1.0, 1.0), False),
        t_crop=replay_batch_transform(jax.random.fold_in(k_t, 1), bu, cfg.scale_range, False),
        u_aug=replay_batch_transform(k_aug2, bu, (1.0, 1.0), True),
        mix=replay_mix(k_mix, bu, cfg.crop_hw),
        contrast=replay_contrast(k_contrast, cfg.num_classes, cfg.num_queries,
                                 (bl + bu) * h * w),
    )


def _batch(seed, canvas=40):
    rng = np.random.default_rng(seed)
    return {
        "l_image": rng.random((B, canvas, canvas, 3), dtype=np.float32),
        "l_label": rng.integers(0, C, size=(B, canvas, canvas)).astype(np.int32),
        "l_valid_hw": np.array([[canvas, canvas], [canvas - 6, canvas - 3]], np.int32),
        "u_image": rng.random((B, canvas, canvas, 3), dtype=np.float32),
        "u_valid_hw": np.full((B, 2), canvas, np.int32),
    }


def _setup(**overrides):
    cfg = dict(CFG, **overrides)
    jcfg = JaxStepConfig(**cfg)
    jmodel = jax_build_model(num_classes=C, output_dim=D, backbone="tiny")
    tx = make_optimizer(**OPT)
    jstate = jax_create_state(jax.random.key(0), jmodel, tx, (1, CROP, CROP, 3),
                              num_classes=C, output_dim=D)
    jstep = jax.jit(jax_make_step(jmodel, tx, jcfg))

    model = build_model(C, D, "tiny")
    model.load_state_dict(from_jax_variables(jstate.params, jstate.batch_stats), strict=True)
    tstate = create_train_state(model, C, D, **OPT, device="cpu")
    tstep = make_train_step(StepConfig(**cfg))
    return jcfg, jstate, jstep, tstate, tstep


def _run(n_steps, seed=0, **overrides):
    """Runs both steps ``n_steps`` times; yields (jax metrics, jax state,
    port metrics, port state) after each step."""
    jcfg, jstate, jstep, tstate, tstep = _setup(**overrides)
    key = jax.random.key(1)
    for i in range(n_steps):
        batch = _batch(seed + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           jnp.float32(1.0), jnp.asarray(False))
        draws = replay_step_draws(key, i, jcfg, B, B)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                           draws, 1.0)
        yield jm, jstate, tm, tstate


def _assert_losses(jm, tm, rtol=LOSS_RTOL):
    for name in ("sup", "unsup", "contrast", "total"):
        assert np.isfinite(float(tm[name])), name
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=rtol, atol=1e-6,
                                   err_msg=name)


def _assert_tree(got_module, params, stats, param_atol, stat_atol):
    got = got_module.state_dict()
    for key, want in from_jax_variables(params, stats).items():
        atol = stat_atol if key.endswith(("running_mean", "running_var")) else param_atol
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0, atol=atol,
                                   err_msg=key)


def _assert_step(jm, jstate, tm, tstate, param_atol=PARAM_ATOL, stat_atol=STAT_ATOL):
    _assert_losses(jm, tm)
    assert tstate.step == int(jstate.step)
    _assert_tree(tstate.model, jstate.params, jstate.batch_stats, param_atol, stat_atol)
    _assert_tree(tstate.teacher, jstate.ema_params, jstate.ema_batch_stats, param_atol,
                 stat_atol)
    np.testing.assert_allclose(tstate.prototypes.numpy(), np.asarray(jstate.prototypes),
                               rtol=0, atol=STAT_ATOL)


def test_ori_step_matches_jax():
    ((jm, jstate, tm, tstate),) = list(_run(1, **LIVE_UNSUP))
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    _assert_step(jm, jstate, tm, tstate)


def test_ori_three_step_trajectory_matches_jax():
    run = _run(3, seed=10)
    _assert_step(*next(run))          # first touch of the prototypes, EMA decay 0
    _assert_step(*next(run), param_atol=STEP1_PARAM_ATOL,  # momentum, EMA decay 1/2,
                 stat_atol=STEP1_STAT_ATOL)                # prototype EMA
    jm, jstate, tm, tstate = next(run)
    assert tstate.step == int(jstate.step) == 3
    _assert_losses(jm, tm, rtol=LATE_LOSS_RTOL)


def test_step_refuses_paths_not_ported():
    for strategy in ("mix", "cross"):       # ported: tests/test_torch_strategies.py
        for mix_mode in ("none", "cutout", "cutmix", "classmix"):
            assert callable(make_train_step(StepConfig(**CFG, strategy=strategy,
                                                       mix_mode=mix_mode)))
    # ported: OHEM and the fused forward (tests/test_torch_cityscapes_step.py)
    for strategy in ("ori", "mix", "cross"):
        assert callable(make_train_step(StepConfig(**CFG, strategy=strategy, sup_loss="ohem",
                                                   fused_forward=True)))
    with pytest.raises(ValueError, match="strategy"):
        make_train_step(StepConfig(**CFG, strategy="bogus"))
    with pytest.raises(ValueError, match="mix mode"):
        make_train_step(StepConfig(**CFG, mix_mode="bogus"))
    with pytest.raises(ValueError, match="sup_loss"):
        make_train_step(StepConfig(**CFG, sup_loss="focal"))
    # ported: the other negative modes (tests/test_torch_negative_mode_steps.py)
    # and the uint8 augmentation law (tests/test_torch_quantized_step.py)
    for mode in ("sampled_pallas", "sampled", "expected", "expected_pallas"):
        assert callable(make_train_step(StepConfig(**CFG, negative_mode=mode,
                                                   aug_quantize=True)))
    with pytest.raises(ValueError, match="negative_mode"):
        make_train_step(StepConfig(**CFG, negative_mode="bogus"))
