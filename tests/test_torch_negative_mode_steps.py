"""One ``ori`` train step per negative mode (``sampled``, ``expected``,
``expected_pallas``) against css_tpu's step, on the tiny trunk, from the
same weights, batch and replayed draws, at the tolerances of
tests/test_torch_train_step.py (stated there) and on its inputs.  css_tpu's
Pallas kernels run in interpret mode on the CPU (``expected_pallas``).

At the loss level the three modes agree with css_tpu to about 1e-7
(tests/test_torch_negative_modes.py); what a step adds is the tiny trunk's
ill-conditioning at batch 2.  On another batch (``_batch(3)``) the ``sampled``
step's student parameters land 6.7e-4 from JAX's, and JAX's own step moves
them by 7.1e-4 when its input images are scaled by (1 + 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import build_model as jax_build_model
from css_tpu.ops.pallas import contrastive_kernels as jck
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu.train.train_step import StepConfig as JaxStepConfig
from css_tpu.train.train_step import make_train_step as jax_make_step
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.models.resnet import resnet_tiny
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import StepConfig, make_train_step
from tests.test_torch_negative_modes import replay_contrast_mode
from tests.test_torch_train_step import (B, C, CFG, CROP, D, LIVE_UNSUP, OPT, _assert_step,
                                         _batch, replay_step_draws)
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_start():
    """css_tpu's tiny model, optimizer and initial state, built once."""
    jmodel = jax_build_model(num_classes=C, output_dim=D, backbone="tiny")
    tx = make_optimizer(**OPT)
    jstate = jax_create_state(jax.random.key(0), jmodel, tx, (1, CROP, CROP, 3),
                              num_classes=C, output_dim=D)
    return jmodel, tx, jstate


@pytest.mark.parametrize("mode", ["sampled", "expected", "expected_pallas"])
def test_one_step_per_negative_mode_matches_jax(jax_start, monkeypatch, mode):
    orig = jck.pl.pallas_call
    monkeypatch.setattr(jck.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jmodel, tx, jstate = jax_start
    cfg = dict(CFG, negative_mode=mode, **LIVE_UNSUP)
    jcfg = JaxStepConfig(**cfg)
    batch = _batch(0)      # the inputs of test_ori_step_matches_jax
    key = jax.random.key(1)
    jstate, jm = jax.jit(jax_make_step(jmodel, tx, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(1.0),
        jnp.asarray(False))

    model = build_model(C, D, "tiny")
    model.load_state_dict(from_jax_variables(jax_start[2].params, jax_start[2].batch_stats),
                          strict=True)
    tstate = create_train_state(model, C, D, **OPT, device="cpu")
    draws = replay_step_draws(key, 0, jcfg, B, B)
    k_contrast = jax.random.split(jax.random.fold_in(key, 0), 4)[3]
    h, w = resnet_tiny().low_level_hw(jcfg.crop_hw)
    draws.contrast = replay_contrast_mode(k_contrast, mode, C, jcfg.num_queries,
                                          jcfg.num_negatives, 2 * B * h * w)
    tstate, tm = make_train_step(StepConfig(**cfg))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws, 1.0)
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    _assert_step(jm, jstate, tm, tstate)
