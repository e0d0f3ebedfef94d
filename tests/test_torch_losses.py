"""The port's losses (css_tpu_torch/losses) against css_tpu.

The contrastive loss draws from a key on the JAX side; ``replay_contrast``
re-derives its draws (contrastive.py:186,224,305 and
contrastive_kernels.py:126) and hands them to the port.  The JAX loss on the
CPU takes its dense route (contrastive_kernels.py:146-151), the port its
plain K1/K2; both round the anchors and the table to bf16.

Tolerances: CE and the threshold loss are f32 reductions in another order
(rtol 1e-5); prototypes are per-class means (rtol 1e-5, atol 1e-6); the
contrastive loss and its gradient carry the bf16 operands and K2's bf16
exp (rtol 1e-4 on the loss; gradient atol 2e-4 against a largest entry of
about 1e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.losses import contrastive as jcon
from css_tpu.losses.cross_entropy import cross_entropy as j_ce
from css_tpu.losses.threshold import attention_threshold_loss as j_thr
from css_tpu_torch.losses import contrastive as tcon
from css_tpu_torch.losses.cross_entropy import cross_entropy as t_ce
from css_tpu_torch.losses.threshold import attention_threshold_loss as t_thr
from css_tpu_torch.train.draws import ContrastDraws


def _t(x):
    return torch.from_numpy(np.array(x))


def replay_contrast(rng, num_classes, num_queries, n) -> ContrastDraws:
    """The draws of prototype_contrastive_loss(..., rng, negative_mode=
    'sampled_pallas') for N = n pixels."""
    _, r_tie2, r_anchor, _, r_negpix = jax.random.split(rng, 5)
    tie = jax.random.bits(r_tie2, (n,), dtype=jnp.uint32) >> jnp.uint32(8)
    u1 = jax.random.uniform(r_anchor, (num_classes, num_queries))
    u = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jax.random.split(r_negpix, num_classes))
    return ContrastDraws(tie=_t(tie.astype(jnp.int32)), u1=_t(u1), u=_t(u))


def _logits_labels(seed, shape=(2, 12, 10), c=5, ignore=0.2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((*shape, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, size=shape).astype(np.int32)
    labels[rng.random(shape) < ignore] = -1
    return logits, labels


@pytest.mark.parametrize("ignore", [0.0, 0.3, 1.0])
def test_cross_entropy(ignore):
    logits, labels = _logits_labels(0, ignore=ignore)
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(t_ce(_t(logits), _t(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("conf_scale", [0.5, 1.0])
def test_attention_threshold_loss(conf_scale):
    logits, labels = _logits_labels(1, ignore=0.3)
    conf = (np.random.default_rng(2).random(labels.shape) * conf_scale + 0.5).astype(np.float32)
    labels[1] = -1   # an image without any valid pseudo-label gets weight 0
    want = float(j_thr(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(conf), 0.97))
    got = float(t_thr(_t(logits), _t(labels), _t(conf), 0.97))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_update_prototypes():
    rng = np.random.default_rng(3)
    n, c, d = 400, 6, 16
    rep = rng.standard_normal((n, d)).astype(np.float32)
    cls_id = rng.integers(0, c - 1, size=n).astype(np.int32)   # class c-1 never seen
    member = rng.random(n) < 0.8
    protos = rng.standard_normal((c, d)).astype(np.float32)
    protos[1] = 0.0                                              # first touch
    want, want_cnt = jcon.update_prototypes(jnp.asarray(rep), jnp.asarray(cls_id),
                                            jnp.asarray(member), jnp.asarray(protos), 0.99)
    got, got_cnt = tcon.update_prototypes(_t(rep), _t(cls_id), _t(member), _t(protos), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got[c - 1].numpy(), protos[c - 1])


def test_grouped_random_order_matches_jax():
    rng = np.random.default_rng(4)
    n, c = 5000, 7
    cls_id = rng.integers(0, c, size=n).astype(np.int32)
    member = rng.random(n) < 0.6
    key = jax.random.key(5)
    want = jcon._grouped_random_order(jnp.asarray(cls_id), jnp.asarray(member), key, c)
    tie = (jax.random.bits(key, (n,), dtype=jnp.uint32) >> jnp.uint32(8)).astype(jnp.int32)
    got = tcon.grouped_random_order(_t(cls_id), _t(member), _t(tie), c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _contrast_inputs(seed, b=4, h=6, w=5, d=32, c=5, protos_zero=False):
    rng = np.random.default_rng(seed)
    rep = rng.standard_normal((b, h, w, d)).astype(np.float32)
    lab = rng.integers(0, c, size=(b, h, w))
    onehot = np.eye(c, dtype=np.float32)[lab]
    onehot[rng.random((b, h, w)) < 0.1] = 0.0                  # ignore pixels
    mask = (rng.random((b, h, w)) < 0.8).astype(np.float32)
    logits = rng.standard_normal((b, h, w, c)).astype(np.float32) * 3
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    protos = (np.zeros((c, d)) if protos_zero
              else rng.standard_normal((c, d))).astype(np.float32)
    return rep, onehot, mask, prob.astype(np.float32), protos


@pytest.mark.parametrize("seed,protos_zero,strong", [(0, False, 0.97), (1, True, 0.97),
                                                     (2, False, 0.6)])
def test_prototype_contrastive_loss_sampled_pallas(seed, protos_zero, strong):
    rep, onehot, mask, prob, protos = _contrast_inputs(seed, protos_zero=protos_zero)
    q, g, c = 8, 16, onehot.shape[-1]
    key = jax.random.key(100 + seed)

    def j_loss(rep_):
        return jcon.prototype_contrastive_loss(
            rep_, jnp.asarray(onehot), jnp.asarray(mask), jnp.asarray(prob),
            jnp.asarray(protos), key, num_queries=q, num_negatives=g,
            strong_threshold=strong, negative_mode="sampled_pallas")

    (want, want_protos), want_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(rep))

    draws = replay_contrast(key, c, q, rep.shape[0] * rep.shape[1] * rep.shape[2])
    rep_t = _t(rep).requires_grad_(True)
    got, got_protos = tcon.prototype_contrastive_loss(
        rep_t, _t(onehot), _t(mask), _t(prob), _t(protos), **draws.as_kwargs(),
        num_negatives=g, strong_threshold=strong)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(got_protos.numpy(), np.asarray(want_protos), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(want_grad)).max() > 1e-4
    np.testing.assert_allclose(rep_t.grad.numpy(), np.asarray(want_grad), atol=2e-4)


def test_contrastive_loss_is_zero_with_one_valid_class():
    rep, onehot, mask, prob, protos = _contrast_inputs(3)
    onehot[..., 1:] = 0.0
    onehot[..., 0] = 1.0
    draws = replay_contrast(jax.random.key(0), onehot.shape[-1], 8, rep[..., 0].size)
    got, _ = tcon.prototype_contrastive_loss(_t(rep), _t(onehot), _t(mask), _t(prob),
                                             _t(protos), **draws.as_kwargs(), num_negatives=16)
    assert float(got) == 0.0
