"""The port's ops/interpolate, ops/onehot and models (DeepLabV3+ dual head
on the tiny trunk) against css_tpu, with weights passed through
``from_jax_variables``.

Everything runs in f32.  Tolerances: resizes of O(1) values agree to f32
rounding (the JAX side builds dense interpolation matrices from float64
positions, the port's F.interpolate works in f32): atol 1e-5.  The network
differs only in the order of f32 sums inside convolutions and reductions:
eval mode and the trunk's BatchNorm stats to rtol 1e-4, atol 1e-5.  The
train-mode outputs, and the stats downstream of ASPP, are ill-conditioned at batch 2 (the ASPP pool BN normalizes n = 2
values, so E[x^2] - E[x]^2 cancels): a 1e-7 relative perturbation of the
input moves JAX's own outputs by 1.5e-4, so they are held to atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.models import build_model as jax_build_model
from css_tpu.ops import interpolate as jint
from css_tpu.ops import onehot as joh
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.ops import interpolate as tint
from css_tpu_torch.ops import onehot as toh

RTOL, ATOL = 1e-4, 1e-5
TRAIN_ATOL = 1e-3


@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7), (9, 9)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_resize(out_hw, align_corners):
    x = np.random.default_rng(0).standard_normal((2, 9, 12, 5)).astype(np.float32)
    want = np.asarray(jint.bilinear_resize(jnp.asarray(x), out_hw, align_corners))
    got = tint.bilinear_resize(torch.from_numpy(x), out_hw, align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw", [((2, 32, 32), (8, 8)), ((2, 31, 17, 3), (8, 5)),
                                          ((13, 10), (4, 7))])
def test_nearest_resize(shape, out_hw):
    x = np.random.default_rng(1).integers(-1, 9, size=shape).astype(np.int32)
    want = np.asarray(jint.nearest_resize(jnp.asarray(x), out_hw, convention="torch"))
    got = tint.nearest_resize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_label_onehot():
    lab = np.random.default_rng(2).integers(-1, 6, size=(2, 5, 7)).astype(np.int32)
    want = np.asarray(joh.label_onehot(jnp.asarray(lab), 6))
    np.testing.assert_array_equal(toh.label_onehot(torch.from_numpy(lab), 6).numpy(), want)


def _tiny_pair(num_classes=5, output_dim=16, hw=(32, 32)):
    jmodel = jax_build_model(num_classes=num_classes, output_dim=output_dim, backbone="tiny")
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, *hw, 3)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    # non-trivial running stats, so eval mode exercises them
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda s: jnp.asarray(np.asarray(s) + rng.random(s.shape)
                                               .astype(np.float32) * 0.5), stats)
    tmodel = build_model(num_classes, output_dim, "tiny")
    tmodel.load_state_dict(from_jax_variables(params, stats), strict=True)
    return jmodel, params, stats, tmodel


def test_from_jax_variables_covers_every_tensor():
    jmodel, params, stats, tmodel = _tiny_pair()
    sd = from_jax_variables(params, stats)
    assert set(sd) == set(tmodel.state_dict())
    k = sd["backbone.stem.conv.weight"]
    assert tuple(k.shape) == (64, 3, 7, 7)


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_deeplab_train_mode_outputs_and_bn_stats(hw):
    jmodel, params, stats, tmodel = _tiny_pair(hw=hw)
    x = np.random.default_rng(4).standard_normal((2, *hw, 3)).astype(np.float32)
    (pred_j, rep_j), upd = jmodel.apply({"params": params, "batch_stats": stats},
                                        jnp.asarray(x), train=True, mutable=["batch_stats"])
    tmodel.train()
    pred_t, rep_t = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(pred_t.detach().numpy(), np.asarray(pred_j), atol=1e-2)
    np.testing.assert_allclose(rep_t.detach().numpy(), np.asarray(rep_j), atol=1e-2)
    want_sd = from_jax_variables(params, upd["batch_stats"])
    got_sd = tmodel.state_dict()
    for key, want in want_sd.items():
        if key.endswith(("running_mean", "running_var")):
            atol = ATOL if key.startswith("backbone.") else TRAIN_ATOL
            np.testing.assert_allclose(got_sd[key].numpy(), want.numpy(), rtol=RTOL,
                                       atol=atol, err_msg=key)


def test_deeplab_eval_mode():
    jmodel, params, stats, tmodel = _tiny_pair()
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    pred_j, rep_j = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 train=False)
    tmodel.eval()
    with torch.no_grad():
        pred_t, rep_t = tmodel(torch.from_numpy(x))
    assert pred_t.shape == (2, 8, 8, 5) and rep_t.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rep_t.numpy(), np.asarray(rep_j), rtol=RTOL, atol=ATOL)


@pytest.mark.slow
def test_resnet101_train_mode_parity():
    """ResNet-101 at a small input.  Its train-mode forward is worse
    conditioned than the tiny trunk's: a 1e-7 relative perturbation of the
    input moves JAX's own outputs by 3e-3 (outputs up to 1.9), so atol 1e-2."""
    hw = (64, 64)
    jmodel = jax_build_model(num_classes=21, output_dim=256, backbone="resnet101")
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, *hw, 3)), train=False)
    tmodel = build_model(21, 256, "resnet101")
    tmodel.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]))
    x = np.random.default_rng(6).standard_normal((2, *hw, 3)).astype(np.float32)
    (pred_j, rep_j), _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    tmodel.train()
    pred_t, rep_t = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(pred_t.detach().numpy(), np.asarray(pred_j), atol=1e-2)
    np.testing.assert_allclose(rep_t.detach().numpy(), np.asarray(rep_j), atol=1e-2)
