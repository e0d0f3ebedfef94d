"""The uint8 augmentation law (``quantize=True`` of css_tpu_torch/ops/
{augment,photometric}.py) against css_tpu's functions and against PIL.

css_tpu's functions run op by op here (eagerly, or under
``jax.disable_jit``), as its own differential tests against PIL
(tests/test_reference_differential.py:930-1040, tests/test_blur_law.py:91)
run them: under ``jit`` XLA folds the entry hop's two divisions into one
multiply and fuses the blends' multiply-adds, which moves some pixels one
uint8 step off the law (``test_jitted_css_tpu_departs_from_its_law``).

Against css_tpu the port is expected to be exact; it is held to at most one
uint8 step with at least 99.9% of pixels exact.  Against PIL: the
thresholds of the JAX tests (brightness, contrast and saturation exact; hue
exact on 99.5% of pixels and within 8 steps; the blur within one step on
99.5% of pixels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image, ImageEnhance, ImageFilter

from css_tpu.ops import augment as jaug
from css_tpu.ops import photometric as jphoto
from css_tpu_torch.ops import augment as taug
from css_tpu_torch.ops import photometric as tphoto
from tests.test_torch_augment import replay_batch_transform
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

FACTORS = (0.77, 0.8, 1.18, 1.21)
HUES = (-0.25, -0.22, 0.19, 0.25)
SIGMAS = (0.15, 0.4, 0.77, 1.0, 1.15)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_q8(got, want):
    """At most one uint8 step apart, at least 99.9% of pixels exact."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= 1.0 / 255.0 + 1e-6, err.max() * 255
    assert np.mean(err == 0) >= 0.999, np.mean(err == 0)


def _u8(seed, b=3, h=33, w=47):
    return np.random.default_rng(seed).integers(0, 256, (b, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_q8_jitter_ops_match_css_tpu(op):
    k = _u8(0)
    jfn = {"brightness": jphoto._q8_brightness255, "contrast": jphoto._q8_contrast255,
           "saturation": jphoto._q8_saturation255, "hue": jphoto._pil_hue_shift255}[op]
    tfn = {"brightness": tphoto._q8_brightness255, "contrast": tphoto._q8_contrast255,
           "saturation": tphoto._q8_saturation255, "hue": tphoto._pil_hue_shift255}[op]
    for f in (HUES if op == "hue" else FACTORS):
        want = np.stack([jfn(jnp.asarray(x), jnp.float32(f)) for x in k]) / 255.0
        got = tfn(_t(k), torch.full((k.shape[0],), f)).numpy() / 255.0
        _assert_q8(got, want)


def test_q8_entry_hops_and_gray_match_css_tpu():
    rng = np.random.default_rng(1)
    on_grid = (rng.integers(0, 256, (2, 3, 20, 30)) / 255.0).astype(np.float32)
    off_grid = rng.random((2, 3, 20, 30), dtype=np.float32)
    for x in (on_grid, off_grid):
        _assert_q8(tphoto.q8_entry_image(_t(x)),
                   np.stack([jphoto.q8_entry_image(jnp.asarray(xi)) for xi in x]))
        _assert_q8(tphoto.q8_floor(_t(x)), jphoto.q8_floor(jnp.asarray(x)))
        _assert_q8(tphoto.q8_round(_t(x)), jphoto.q8_round(jnp.asarray(x)))
    k = _u8(2)
    _assert_q8(tphoto._pil_gray255(_t(k))[:, 0].numpy() / 255.0,
               np.stack([jphoto._pil_gray255(jnp.asarray(x)) for x in k]) / 255.0)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_q8_blur_matches_css_tpu_and_pil(sigma):
    img = _u8(3, b=2, h=48, w=64)
    got = tphoto.pil_gaussian_blur(_t(img / 255.0), torch.full((2,), sigma),
                                   quantize=True).numpy()
    want = np.stack([jphoto.pil_gaussian_blur(jnp.asarray(x / 255.0), jnp.float32(sigma),
                                              quantize=True) for x in img])
    _assert_q8(got, want)
    for i in range(2):   # tests/test_blur_law.py:91's thresholds
        pil = Image.fromarray(img[i].transpose(1, 2, 0).astype(np.uint8))
        ref = np.asarray(pil.filter(ImageFilter.GaussianBlur(radius=sigma)),
                         np.float64).transpose(2, 0, 1) / 255.0
        err = np.abs(ref - got[i])
        assert err.max() <= 1.0 / 255.0 + 1e-6, (sigma, err.max() * 255.0)
        assert np.mean(err < 1e-6) > 0.995, (sigma, np.mean(err < 1e-6))


def _pil_hue(pil, factor):
    """torchvision's PIL hue op: H of the HSV image moved by
    uint8(factor * 255) with wraparound."""
    h, s, v = pil.convert("HSV").split()
    shift = int(np.trunc(np.float32(factor) * np.float32(255.0))) % 256
    h = Image.fromarray(((np.asarray(h, np.int64) + shift) % 256).astype(np.uint8), "L")
    return Image.merge("HSV", (h, s, v)).convert("RGB")


@pytest.mark.parametrize("op,factor", [("brightness", 0.77), ("brightness", 1.21),
                                       ("contrast", 0.8), ("contrast", 1.18),
                                       ("saturation", 0.76), ("saturation", 1.22),
                                       ("hue", -0.22), ("hue", 0.19), ("hue", 0.25),
                                       ("hue", -0.25)])
def test_q8_jitter_ops_match_pil(op, factor):
    img = np.random.default_rng(3).integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    pil = Image.fromarray(img, "RGB")
    enhance = {"brightness": ImageEnhance.Brightness, "contrast": ImageEnhance.Contrast,
               "saturation": ImageEnhance.Color}
    want = np.asarray(_pil_hue(pil, factor) if op == "hue"
                      else enhance[op](pil).enhance(factor), np.int32)
    fn = {"brightness": tphoto._q8_brightness255, "contrast": tphoto._q8_contrast255,
          "saturation": tphoto._q8_saturation255, "hue": tphoto._pil_hue_shift255}[op]
    k = _t(img.transpose(2, 0, 1)[None].astype(np.float32))
    got = fn(k, torch.tensor([factor], dtype=torch.float32))[0].numpy().transpose(1, 2, 0)
    err = np.abs(want - got)
    if op == "hue":
        assert np.mean(err == 0) > 0.995, np.mean(err == 0)
        assert err.max() <= 8, err.max()
    else:
        assert err.max() == 0, (op, factor, err.max(), (err > 0).sum())


@pytest.mark.parametrize("valid,scale_range,augmentation", [
    ((60, 75), (0.5, 1.5), False),   # down- and up-scale, reflect and ignore padding
    ((44, 30), (0.5, 2.0), True),    # ragged valid region, jitter, blur, flip
    ((60, 75), (1.5, 2.0), True),    # upscale, several weight windows a row
    ((60, 75), (0.35, 0.45), True),  # antialiased downscale, padding
])
def test_quantized_batch_transform_matches_css_tpu(valid, scale_range, augmentation):
    """The whole uint8 chain (entry hops, fixed-point resample, jitter,
    blur, flip) against css_tpu's ``batch_transform(quantize=True)`` op by
    op, on uint8-born images and off-grid confidences, with its draws.  One
    canvas and crop shape (op-by-op JAX compiles each operation per shape);
    the cases differ in values."""
    b, canvas, crop = 4, (60, 75), (32, 40)
    rng = np.random.default_rng(5)
    img = (rng.integers(0, 256, (b, 3, *canvas)) / 255.0).astype(np.float32)
    labels = rng.integers(-1, 5, (b, 1, *canvas)).astype(np.int32)
    confs = rng.random((b, 2, *canvas), dtype=np.float32)
    valid_hw = np.tile(np.asarray(valid, np.int32), (b, 1))
    key = jax.random.key(11)
    with jax.disable_jit():
        want = jaug.batch_transform(key, jnp.asarray(img), jnp.asarray(labels),
                                    jnp.asarray(confs), jnp.asarray(valid_hw), crop_hw=crop,
                                    scale_range=scale_range, augmentation=augmentation,
                                    quantize=True)
    draws = replay_batch_transform(key, b, scale_range, augmentation)
    got = taug.batch_transform(_t(img), _t(labels), _t(confs), _t(valid_hw), crop,
                               **draws.as_kwargs(), quantize=True)
    _assert_q8(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _assert_q8(got[2], want[2])


@pytest.mark.parametrize("n", [7, 37, 64, 150, 769, 2048])
def test_row_sum_takes_xla_order(n):
    """``_row_sum_xla_order`` reproduces XLA's CPU reduce bit for bit on
    rows of a few nonzero weights (what the triangle filter gives), where
    torch's own sum differs in the last bit on some rows."""
    rng = np.random.default_rng(n)
    rows = np.zeros((3000, n), np.float32)
    for r in range(rows.shape[0]):
        k = int(rng.integers(2, min(10, n)))
        j = int(rng.integers(0, n - k + 1))
        rows[r, j:j + k] = rng.random(k, dtype=np.float32) * 10.0 ** rng.integers(-3, 1)
    with jax.disable_jit():
        want = np.asarray(jnp.asarray(rows).sum(axis=1))
    got = taug._row_sum_xla_order(_t(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda x: x.sum(axis=1))(rows)), want)


def test_jitted_css_tpu_departs_from_its_law():
    """css_tpu under ``jit``: XLA folds ``((x - m) / s) / f32(1/s)`` into
    ``(x - m) * c`` (c = 0.999999881 on the green channel), which moves some
    on-grid intensities a uint8 step from the f32 chain css_tpu documents and
    runs op by op; the port keeps the chain."""
    x = jnp.asarray((np.arange(256, dtype=np.float32) / 255.0)[None, :, None]
                    .repeat(3, 0))
    eager = np.asarray(jphoto.q8_entry_image(x))
    jitted = np.asarray(jax.jit(jphoto.q8_entry_image)(x))
    port = tphoto.q8_entry_image(_t(x)[None])[0].numpy()
    np.testing.assert_array_equal(port, eager)
    assert (jitted != eager).any()
