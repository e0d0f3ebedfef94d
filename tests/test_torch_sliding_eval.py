"""Sliding-window eval (``make_sliding_eval_step``, ``_tile_origins``,
``window_probs``) and predict's segmenting against css_tpu's, on the tiny
trunk in f32 with css_tpu's weights carried across.

The canvas is non-square with several windows on each axis (48 x 80, crop
32: 2 x 4 windows at the default stride), which css_tpu's own tests do not
cover (tests/test_tta_eval.py uses square canvases).  Both sides compute
the same f32 probabilities in another order, so an argmax may flip on a
near-tie: the confusion matrices must count the same pixels, and their
cells may differ by at most 0.1% of the counted pixels in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import build_model as jax_build_model
from css_tpu.ops.interpolate import bilinear_resize as jax_bilinear_resize
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu.train import train_step as jts
from css_tpu_torch.cli import predict_main
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train import train_step as tts
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

C, D = 5, 16
CANVAS, CROP = (48, 80), (32, 32)
NEAR_TIE_SHARE = 1e-3


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(num_classes=C, output_dim=D, backbone="tiny")
    jstate = jax_create_state(jax.random.key(2), jmodel, make_optimizer(1e-3, 0.0, 1),
                              (1, *CROP, 3), num_classes=C, output_dim=D)
    # running statistics other than the initial (0, 1), so eval-mode BN matters
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda x: x + jnp.asarray(
        np.abs(rng.standard_normal(x.shape)).astype(np.float32) * 0.1), jstate.batch_stats)
    model = build_model(C, D, "tiny")
    model.load_state_dict(from_jax_variables(jstate.params, stats), strict=True)
    return jmodel, jstate.params, stats, model, jax.jit(
        lambda x: jmodel.apply({"params": jstate.params, "batch_stats": stats}, x,
                               train=False)[0])


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((b, *CANVAS, 3)).astype(np.float32)
    label = rng.integers(0, C, (b, *CANVAS)).astype(np.int32)
    label[rng.random((b, *CANVAS)) < 0.1] = -1
    label[:, 40:] = -1                         # the canvas's padded rows
    valid = np.array([True] * (b - 1) + [False])
    return image, label, valid


@pytest.mark.parametrize("full,crop,stride", [(48, 32, 21), (80, 32, 21), (32, 32, 21),
                                              (20, 32, 21), (1024, 769, 512),
                                              (2048, 769, 512), (100, 30, 7)])
def test_tile_origins_match_css_tpu(full, crop, stride):
    assert tts._tile_origins(full, crop, stride) == jts._tile_origins(full, crop, stride)


@pytest.mark.parametrize("flip,scales", [(False, (1.0,)), (True, (1.0,)),
                                         (False, (0.75, 1.0, 1.25))],
                         ids=["plain", "flip", "scales"])
def test_sliding_eval_matches_css_tpu_on_a_non_square_canvas(models, flip, scales):
    jmodel, params, stats, model, _ = models
    image, label, valid = _batch(1)
    jstep = jax.jit(jts.make_sliding_eval_step(jmodel, C, CANVAS, CROP, flip=flip,
                                               scales=scales))
    want = np.asarray(jstep(params, stats, jnp.zeros((C, C), jnp.int32), jnp.asarray(image),
                            jnp.asarray(label), jnp.asarray(valid)))
    tstep = tts.make_sliding_eval_step(model, C, CANVAS, CROP, flip=flip, scales=scales)
    got = tstep(torch.zeros((C, C), dtype=torch.int64), torch.from_numpy(image),
                torch.from_numpy(label), torch.from_numpy(valid)).numpy()
    counted = int(((label >= 0) & valid[:, None, None]).sum())
    assert got.sum() == want.sum() == counted
    assert np.abs(got - want).sum() <= 2 * NEAR_TIE_SHARE * counted, np.abs(got - want).sum()
    assert model.training                      # the step restores the module's mode


def _jax_segment(apply, image, window, stride):
    """predict_main.py's ``predict`` (css_tpu/cli/predict_main.py:137-161)
    assembled from css_tpu's model (``apply``, jitted), ``bilinear_resize``
    and ``_tile_origins``."""
    h, w = image.shape[1:3]
    acc = np.zeros(image.shape[:3] + (C,), np.float32)
    cnt = np.zeros((h, w, 1), np.float32)
    for oy in jts._tile_origins(h, window[0], stride[0]):
        for ox in jts._tile_origins(w, window[1], stride[1]):
            pred = apply(jnp.asarray(image[:, oy:oy + window[0], ox:ox + window[1]]))
            prob = jax.nn.softmax(jax_bilinear_resize(pred, window, align_corners=True)
                                  .astype(jnp.float32), axis=-1)
            acc[:, oy:oy + window[0], ox:ox + window[1]] += np.asarray(prob)
            cnt[oy:oy + window[0], ox:ox + window[1]] += 1.0
    return np.argmax(acc / np.maximum(cnt, 1.0), axis=-1)


@pytest.mark.parametrize("sliding,stride", [(False, None), (True, None), (True, 12)])
def test_segment_matches_css_tpus_predict(models, sliding, stride):
    _, _, _, model, apply = models
    image, _, _ = _batch(2, b=2)
    got = predict_main.segment(model, torch.from_numpy(image), C, CROP, sliding, stride).numpy()
    window = CROP if sliding else CANVAS
    step = ((stride or 2 * CROP[0] // 3, stride or 2 * CROP[1] // 3) if sliding else CANVAS)
    want = _jax_segment(apply, image, window, step)
    assert got.shape == want.shape == image.shape[:3]
    assert np.mean(got != want) <= NEAR_TIE_SHARE
