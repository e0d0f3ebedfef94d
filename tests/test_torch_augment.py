"""Port augmentation (css_tpu_torch/ops/{augment,photometric,mixing}.py)
against css_tpu on the same images and draws.

The JAX functions draw from keys; ``replay_*`` below re-derives the same
draws with ``jax.random`` (the key-split chains of augment.py:245,
photometric.py:213-217,249,403-408 and mixing.py:44-49,121) and hands them to
the port as tensors.  The train-step parity test reuses these helpers.

Tolerances.  The geometric resample rounds its operands to bf16 on both
sides (augment.py:207-212); the f32 triangle weights are normalised with
sums in another order, so an entry can round to the neighbouring bf16 value,
one step of 2^-8 relative: images are held to atol 2e-2 and a mean error
below 2e-4.  Nearest-sampled labels and confidences are exact.  The float
photometric ops differ only in f32 sum order: atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.ops import augment as jaug
from css_tpu.ops import mixing as jmix
from css_tpu.ops import photometric as jphoto
from css_tpu_torch.ops import augment as taug
from css_tpu_torch.ops import mixing as tmix
from css_tpu_torch.ops import photometric as tphoto
from css_tpu_torch.train.draws import AugmentDraws, MixDraws


def _t(x):
    return torch.from_numpy(np.array(x))


def replay_photometric(key):
    """Per-image draws of photometric.random_photometric(key, ...)."""
    k_dj, k_j, k_db, k_sig = jax.random.split(key, 4)
    k_perm, k_b, k_c, k_s, k_h = jax.random.split(k_j, 5)
    jitter = jnp.stack([jax.random.uniform(k_b, minval=0.75, maxval=1.25),
                        jax.random.uniform(k_c, minval=0.75, maxval=1.25),
                        jax.random.uniform(k_s, minval=0.75, maxval=1.25),
                        jax.random.uniform(k_h, minval=-0.25, maxval=0.25)])
    return dict(do_jitter=jax.random.uniform(k_dj) > 0.2, jitter=jitter,
                jitter_order=jax.random.permutation(k_perm, 4),
                do_blur=jax.random.uniform(k_db) > 0.5,
                sigma=jax.random.uniform(k_sig, minval=0.15, maxval=1.15))


def replay_batch_transform(rng, b, scale_range, augmentation) -> AugmentDraws:
    """The draws of augment.batch_transform(rng, ...) over a batch of b."""
    def one(key):
        k_scale, k_i, k_j, k_photo, k_flip = jax.random.split(key, 5)
        out = dict(ratio=jax.random.uniform(k_scale, minval=scale_range[0],
                                            maxval=scale_range[1]),
                   u_y=jax.random.uniform(k_i), u_x=jax.random.uniform(k_j))
        if augmentation:
            out.update(replay_photometric(k_photo))
            out["do_flip"] = jax.random.uniform(k_flip) > 0.5
        return out

    draws = jax.vmap(one)(jax.random.split(rng, b))
    draws = {k: _t(v) for k, v in draws.items()}
    if augmentation:
        draws["jitter_order"] = draws["jitter_order"].long()
    return AugmentDraws(**draws)


def replay_mix(rng, b, hw) -> MixDraws:
    """The draws of mixing.mix_batch(rng, ..., mode='cutmix') over b images."""
    h, w = hw

    def one(key):
        k_w, k_x, k_y = jax.random.split(key, 3)
        return (jax.random.randint(k_w, (), int(w / 2 + 1), w),
                jax.random.uniform(k_x), jax.random.uniform(k_y))

    cut_w, u_x, u_y = jax.vmap(one)(jax.random.split(rng, b))
    return MixDraws(cut_w=_t(cut_w).long(), u_x=_t(u_x), u_y=_t(u_y))


def _images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = rng.random((b, 3, h, w), dtype=np.float32)
    labels = rng.integers(-1, 5, size=(b, 1, h, w)).astype(np.int32)
    confs = rng.random((b, 2, h, w), dtype=np.float32)
    return img, labels, confs


def _assert_images_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert np.abs(got - want).mean() < 2e-4


@pytest.mark.parametrize("canvas,valid,crop,scale_range", [
    ((40, 48), (40, 48), (32, 32), (0.5, 1.5)),   # down- and up-scale, pad
    ((50, 37), (44, 30), (24, 32), (0.5, 2.0)),   # ragged valid region
    ((32, 32), (32, 32), (32, 32), (1.0, 1.0)),   # identity geometry
])
def test_apply_geometric(canvas, valid, crop, scale_range):
    b = 3
    img, labels, confs = _images(0, b, *canvas)
    valid_hw = np.tile(np.asarray(valid, np.int32), (b, 1))
    draws = replay_batch_transform(jax.random.key(3), b, scale_range, False)
    want = [jaug.apply_geometric(jnp.asarray(img[i]), jnp.asarray(labels[i]),
                                 jnp.asarray(confs[i]), jnp.asarray(valid_hw[i]), crop,
                                 jnp.asarray(draws.ratio[i].numpy()),
                                 jnp.asarray(draws.u_y[i].numpy()),
                                 jnp.asarray(draws.u_x[i].numpy())) for i in range(b)]
    got = taug.apply_geometric(_t(img), _t(labels).long(), _t(confs), _t(valid_hw), crop,
                               draws.ratio, draws.u_y, draws.u_x)
    _assert_images_close(got[0], np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(got[1].numpy(), np.stack([w[1] for w in want]))
    np.testing.assert_array_equal(got[2].numpy(), np.stack([w[2] for w in want]))


def test_batch_transform_with_photometric_and_flip():
    b, crop = 4, (32, 32)
    img, labels, confs = _images(1, b, 40, 40)
    valid_hw = np.full((b, 2), 40, np.int32)
    key = jax.random.key(7)
    want = jaug.batch_transform(key, jnp.asarray(img), jnp.asarray(labels),
                                jnp.asarray(confs), jnp.asarray(valid_hw), crop_hw=crop,
                                scale_range=(0.5, 1.5), augmentation=True)
    draws = replay_batch_transform(key, b, (0.5, 1.5), True)
    got = taug.batch_transform(_t(img), _t(labels).long(), _t(confs), _t(valid_hw), crop,
                               **draws.as_kwargs())
    _assert_images_close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_color_jitter_and_photometric():
    b = 6
    img = np.random.default_rng(2).random((b, 3, 24, 20), dtype=np.float32)
    keys = jax.random.split(jax.random.key(11), b)
    draws = [replay_photometric(k) for k in keys]
    factors = torch.stack([_t(d["jitter"]) for d in draws])
    order = torch.stack([_t(d["jitter_order"]) for d in draws]).long()

    want_j = np.stack([np.asarray(jphoto.color_jitter(jax.random.split(k, 4)[1],
                                                      jnp.asarray(img[i])))
                       for i, k in enumerate(keys)])
    got_j = tphoto.color_jitter(_t(img), factors, order)
    np.testing.assert_allclose(got_j.numpy(), want_j, atol=1e-5)

    want = np.stack([np.asarray(jphoto.random_photometric(k, jnp.asarray(img[i])))
                     for i, k in enumerate(keys)])
    got = tphoto.random_photometric(
        _t(img), torch.stack([_t(d["do_jitter"]) for d in draws]), factors, order,
        torch.stack([_t(d["do_blur"]) for d in draws]),
        torch.stack([_t(d["sigma"]) for d in draws]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.15, 0.6, 1.15, 1.6])
def test_pil_gaussian_blur(sigma):
    img = np.random.default_rng(4).random((2, 3, 17, 23), dtype=np.float32)
    want = np.stack([np.asarray(jphoto.pil_gaussian_blur(jnp.asarray(x), jnp.float32(sigma)))
                     for x in img])
    got = tphoto.pil_gaussian_blur(_t(img), torch.full((2,), sigma))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_cutmix_mix_batch():
    b, hw = 4, (32, 48)
    img, labels, confs = _images(5, b, *hw)
    key = jax.random.key(13)
    want = jmix.mix_batch(key, jnp.asarray(img), jnp.asarray(labels), jnp.asarray(confs),
                          mode="cutmix", num_classes=5)
    draws = replay_mix(key, b, hw)
    got = tmix.mix_batch(_t(img), _t(labels), _t(confs), **draws.as_kwargs())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    masks = tmix.cutout_box_mask(hw, draws.cut_w, draws.u_x, draws.u_y)
    assert ((masks == 0).float().mean(dim=(1, 2)) > 0.3).all()
