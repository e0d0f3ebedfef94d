"""The port's eval (css_tpu_torch/train/train_step.py ``make_eval_step``,
``_conf_matrix_delta``) and metrics (css_tpu_torch/utils/metrics.py) against
css_tpu's, on the CPU.

The tiny trunk carries JAX's initial weights, with random BatchNorm running
statistics so that eval-mode normalization matters, into the port through
``from_jax_variables``; both sides run in f32.

Tolerances.  The confusion-matrix update and the metrics are integer or
float64 bookkeeping: compared exactly (NaN where a class is empty on both
sides).  The eval steps differ in float summation order (cuDNN-free CPU
convs against XLA's), so a pixel whose two most probable classes are within
1e-4 of each other in JAX's upsampled (averaged) softmax probabilities may
take the other argmax: those pixels are found, counted, and masked out
(label -1) of the comparison of the matrices, which must then be equal;
the matrices' totals must be equal without the mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.models import build_model as jax_build_model
from css_tpu.ops.interpolate import bilinear_resize as jax_bilinear_resize
from css_tpu.train.train_step import _conf_matrix_delta as jax_conf_matrix_delta
from css_tpu.train.train_step import _round_to_multiple as jax_round_to_multiple
from css_tpu.train.train_step import make_eval_step as jax_make_eval_step
from css_tpu.utils import metrics as jax_metrics
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train.train_step import _conf_matrix_delta, _round_to_multiple, make_eval_step
from css_tpu_torch.utils import metrics

C, D, CROP, B = 6, 16, 32, 3
TIE_GAP = 1e-4          # top-2 gap in JAX's probabilities under which argmax may differ
MAX_TIE_SHARE = 0.01    # the masked pixels must stay a small share of all


def _random_stats(tree, rng):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _random_stats(value, rng)
        elif key == "mean":
            out[key] = rng.normal(0.0, 0.2, np.shape(value)).astype(np.float32)
        else:
            out[key] = rng.uniform(0.5, 1.5, np.shape(value)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(num_classes=C, output_dim=D, backbone="tiny")
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, CROP, CROP, 3)), train=False)
    params = variables["params"]
    stats = _random_stats(variables["batch_stats"], np.random.default_rng(0))
    model = build_model(C, D, "tiny")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return jmodel, params, stats, model


def _data(seed):
    rng = np.random.default_rng(seed)
    image = rng.normal(0.0, 1.0, (B, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(-1, C + 2, size=(B, CROP, CROP)).astype(np.int32)
    valid = np.array([True, False, True])
    return image, label, valid


def _jax_probs(jmodel, params, stats, image, flip, scales):
    """JAX's averaged, upsampled softmax probabilities, as its eval step
    forms them (train_step.py:422-452)."""
    variables = {"params": params, "batch_stats": stats}
    h, w = image.shape[1:3]

    def one(im):
        pred, _ = jmodel.apply(variables, im, train=False)
        return jax.nn.softmax(jax_bilinear_resize(pred, (h, w), align_corners=True), axis=-1)

    prob, n = 0.0, 0
    for s in scales:
        im = image if s == 1.0 else jax_bilinear_resize(
            image, (jax_round_to_multiple(h * s), jax_round_to_multiple(w * s)),
            align_corners=True)
        prob, n = prob + one(im), n + 1
        if flip:
            prob, n = prob + one(im[:, :, ::-1])[:, :, ::-1], n + 1
    return np.asarray(prob) / n


def test_conf_matrix_delta_matches_jax():
    rng = np.random.default_rng(1)
    yhat = rng.integers(0, C, size=(4, 9, 7))
    label = rng.integers(-3, C + 3, size=(4, 9, 7)).astype(np.int32)
    valid = np.array([True, False, True, True])
    want = np.asarray(jax_conf_matrix_delta(jnp.asarray(yhat), jnp.asarray(label),
                                            jnp.asarray(valid), C, None))
    got = _conf_matrix_delta(torch.from_numpy(yhat), torch.from_numpy(label),
                             torch.from_numpy(valid), C)
    np.testing.assert_array_equal(got.numpy(), want)
    ok = (label >= 0) & (label < C) & valid[:, None, None]
    assert got.sum().item() == ok.sum() > 0


def test_round_to_multiple_matches_jax():
    for x in (0.0, 3.9, 4.0, 24.0, 31.9, 40.0, 511.5, 640.3):
        assert _round_to_multiple(x) == jax_round_to_multiple(x)


@pytest.mark.parametrize("flip,scales", [(False, (1.0,)), (True, (1.0,)),
                                         (False, (0.75, 1.0, 1.25))],
                         ids=["plain", "flip", "multiscale"])
def test_eval_step_matches_jax(models, flip, scales):
    jmodel, params, stats, model = models
    image, label, valid = _data(seed=7)
    jstep = jax.jit(jax_make_eval_step(jmodel, C, flip=flip, scales=scales))
    tstep = make_eval_step(model, C, flip=flip, scales=scales)
    model.train()   # the step must switch to eval mode and back

    def both(lab):
        want = np.asarray(jstep(params, stats, jnp.zeros((C, C), jnp.int32), jnp.asarray(image),
                                jnp.asarray(lab), jnp.asarray(valid)))
        got = tstep(torch.zeros((C, C), dtype=torch.int64), torch.from_numpy(image),
                    torch.from_numpy(lab), torch.from_numpy(valid)).numpy()
        return want, got

    want, got = both(label)
    counted = ((label >= 0) & (label < C) & valid[:, None, None]).sum()
    assert got.sum() == want.sum() == counted
    assert model.training

    prob = np.sort(_jax_probs(jmodel, params, stats, jnp.asarray(image), flip, scales), axis=-1)
    ties = (prob[..., -1] - prob[..., -2]) < TIE_GAP
    print(f"{flip=} {scales=}: {int(ties.sum())} of {ties.size} pixels within {TIE_GAP} "
          f"of a tie, left out of the matrix comparison")
    assert ties.sum() <= MAX_TIE_SHARE * ties.size
    want, got = both(np.where(ties, -1, label).astype(np.int32))
    np.testing.assert_array_equal(got, want)


def test_eval_step_counts_nothing_for_padded_rows(models):
    _, _, _, model = models
    image, label, _ = _data(seed=3)
    step = make_eval_step(model, C)
    none = step(torch.zeros((C, C), dtype=torch.int64), torch.from_numpy(image),
                torch.from_numpy(label), torch.zeros(B, dtype=torch.bool))
    assert none.sum().item() == 0


def _matrices():
    rng = np.random.default_rng(5)
    full = rng.integers(0, 50, size=(C, C))
    empty = full.copy()
    empty[2, :] = 0
    empty[:, 2] = 0          # class 2 in neither targets nor predictions
    return {"full": full, "empty_class": empty}


@pytest.mark.parametrize("name", ["full", "empty_class"])
def test_iou_metrics_match_jax(name):
    mat = _matrices()[name]
    iou = metrics.per_class_iou(mat)
    np.testing.assert_array_equal(iou, jax_metrics.per_class_iou(mat))
    miou, want = metrics.mean_iou(mat), jax_metrics.mean_iou(mat)
    if name == "empty_class":
        assert np.isnan(iou[2]) and np.isnan(miou) and np.isnan(want)
        assert np.isfinite(np.delete(iou, 2)).all()
    else:
        assert miou == want and np.isfinite(miou)
    cm, jcm = metrics.ConfusionMatrix(C), jax_metrics.ConfusionMatrix(C)
    for _ in range(2):
        cm.update(mat)
        jcm.update(mat)
    np.testing.assert_array_equal(cm.mat, jcm.mat)
    np.testing.assert_array_equal(cm.iou, jcm.iou)


def test_average_meter_matches_jax():
    m, jm = metrics.AverageMeter("loss", ":.3f"), jax_metrics.AverageMeter("loss", ":.3f")
    for val, n in ((1.0, 2), (4.0, 1), (0.5, 3)):
        m.update(val, n)
        jm.update(val, n)
    assert (m.avg, str(m)) == (jm.avg, str(jm))
