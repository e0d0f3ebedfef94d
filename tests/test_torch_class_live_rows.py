"""Every class's compaction at once (``class_live_rows``) against the
per-class arithmetic it replaces, against css_tpu's thinning, and the
contrastive loss through it against the per-class path, on the CPU.

``class_live_rows_plain`` must equal, row for row, ``compact_live_rows_plain``
of the weights the loss built per class (``p_over_cnt[c][masked_cls]``, in
``sampled_pallas`` thinned from G times them): exactly, since it runs the
same operations.  The losses through the new path and through the per-class
path run the same plain K1/K2 on the same compactions, so they are equal bit
for bit.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.ops.pallas import contrastive_kernels as jck
from css_tpu_torch.losses import contrastive as tcon
from css_tpu_torch.ops.kernels import contrastive_kernels as tck
from tests.test_torch_losses import _contrast_inputs
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = ("sampled_pallas", "expected_pallas")
G = 512


def _class_inputs(c, n, seed):
    """``(p_over_cnt [C, C+1], masked_cls [N] int32, u [C, N])``: G * p spans
    [0, 3), so thinned weights reach 2 or 3; 30% of the entries are 0; class 0's
    row is all zero (a class with no live row), class 1 has no pixels, the
    last column (non-members) is 0."""
    rng = np.random.default_rng(seed)
    p = rng.random((c, c + 1)) * (rng.random((c, c + 1)) < 0.7) * (3.0 / G)
    p[0] = 0.0
    p[:, c] = 0.0
    masked = rng.integers(0, c + 1, size=n)
    masked[masked == 1] = c
    u = rng.random((c, n))
    return (torch.from_numpy(p.astype(np.float32)), torch.from_numpy(masked.astype(np.int32)),
            torch.from_numpy(u.astype(np.float32)))


def _per_class(p_over_cnt, masked_cls, u, c):
    """Class c's weights as the loss built them before the batched path."""
    w = p_over_cnt[c][masked_cls.long()]
    return w if u is None else tck.thinned_multiplicities(u[c], G * w)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("c", [3, 21])
@pytest.mark.parametrize("n", [1000, 4133])     # multiples of neither 64 nor 2,048
def test_plain_equals_per_class_composition(mode, c, n):
    p_over_cnt, masked_cls, u = _class_inputs(c, n, seed=c * n)
    u = u if mode == "sampled_pallas" else None
    idx, wv, n_live = tck.class_live_rows_plain(p_over_cnt, masked_cls, G, u)
    n_pad = -(-n // 64) * 64
    assert idx.shape == wv.shape == (c, n_pad) and n_live.shape == (c,)
    assert (idx.dtype, wv.dtype, n_live.dtype) == (torch.int32, torch.float32, torch.int32)
    for k in range(c):
        want_idx, want_wv, want_n = tck.compact_live_rows_plain(_per_class(p_over_cnt,
                                                                           masked_cls, u, k))
        assert torch.equal(idx[k, :n], want_idx) and torch.equal(wv[k, :n], want_wv)
        assert int(n_live[k]) == int(want_n[0])
        assert not idx[k, n:].any() and not wv[k, n:].any()
    assert int(n_live[0]) == 0 and int(n_live.sum()) > 0
    if mode == "sampled_pallas":      # integer parts above 1 reach the compaction
        assert float(wv.max()) >= 2.0 and torch.equal(wv, wv.floor())


@pytest.mark.parametrize("mode", MODES)
def test_plain_all_zero_weights_list_nothing(mode):
    _, masked_cls, u = _class_inputs(5, 777, seed=3)
    idx, wv, n_live = tck.class_live_rows_plain(torch.zeros(5, 6), masked_cls, G,
                                                u if mode == "sampled_pallas" else None)
    assert not n_live.any() and not idx.any() and not wv.any()


@pytest.mark.parametrize("c,n", [(3, 1000), (21, 4133)])
def test_thinned_weights_equal_jax(c, n):
    """The thinned rows and weights against css_tpu's ``thinned_multiplicities``
    (contrastive_kernels.py:119-127) on lam = G * p_over_cnt[c][masked_cls]
    in jnp, each class with its own key and the same uniforms."""
    p_over_cnt, masked_cls, _ = _class_inputs(c, n, seed=7 + c)
    keys = jax.random.split(jax.random.key(c * n), c)
    u = torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (n,))) for k in keys]))
    idx, wv, n_live = tck.class_live_rows_plain(p_over_cnt, masked_cls, G, u)
    p_j, cls_j = jnp.asarray(p_over_cnt.numpy()), jnp.asarray(masked_cls.numpy())
    for k in range(c):
        m = np.asarray(jck.thinned_multiplicities(keys[k], G * p_j[k][cls_j]))
        live = np.nonzero(m)[0]
        assert int(n_live[k]) == live.size
        np.testing.assert_array_equal(idx[k, :live.size].numpy(), live)
        np.testing.assert_array_equal(wv[k, :live.size].numpy(), m[live])


def test_cpu_tensors_take_the_plain_version():
    p_over_cnt, masked_cls, u = _class_inputs(4, 300, seed=2)
    tck.reset_launches()
    got = tck.class_live_rows(p_over_cnt, masked_cls, G, u)
    want = tck.class_live_rows_plain(p_over_cnt, masked_cls, G, u)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tck.LAUNCHES["class_live_rows"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        tck.class_live_rows_kernel(p_over_cnt, masked_cls, G, u)


@pytest.mark.parametrize("kind", ["thinned", "dense"])
def test_live_softsum_equals_weighted_exp_softsum(kind):
    """``weighted_exp_softsum_live`` over a class's row equals
    ``weighted_exp_softsum`` on that class's weights, forward and backward,
    bit for bit."""
    p_over_cnt, masked_cls, u = _class_inputs(5, 900, seed=11)
    u = u if kind == "thinned" else None
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    r = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((900, 32)).astype(np.float32)), dim=1).to(torch.bfloat16)
    idx, wv, n_live = tck.class_live_rows_plain(p_over_cnt, masked_cls, G, u)
    out = []
    for batched in (True, False):
        x = a.clone().requires_grad_(True)
        if batched:
            s = tck.weighted_exp_softsum_live(x, r, idx[3], wv[3], n_live[3:4], 2.0)
        else:
            s = tck.weighted_exp_softsum(x, r, _per_class(p_over_cnt, masked_cls, u, 3), 2.0)
        torch.log(s).sum().backward()
        out.append((s.detach(), x.grad))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_live_softsum_shape_errors():
    r = torch.zeros((64, 256), dtype=torch.bfloat16)
    idx, wv, n_live = torch.zeros(64, dtype=torch.int32), torch.zeros(64), torch.zeros(
        1, dtype=torch.int32)
    with pytest.raises(ValueError, match="matching"):
        tck.weighted_exp_softsum_live(torch.zeros((8, 100)), r, idx, wv, n_live, 2.0)
    with pytest.raises(ValueError, match="n_live"):
        tck.weighted_exp_softsum_live(torch.zeros((8, 256)), r, idx, wv[:63], n_live, 2.0)
    with pytest.raises(ValueError, match="n_live"):
        tck.weighted_exp_softsum_live(torch.zeros((8, 256)), r, idx, wv, n_live[:0], 2.0)


def _loss(mode, seed, per_class, monkeypatch):
    """The loss, its new prototypes and the gradient on ``rep``; with
    ``per_class``, K1/K2 take each class's weights as the loss built them
    before the batched compaction (``weighted_exp_softsum_stochastic`` on
    G times them with u[c], or ``weighted_exp_softsum``)."""
    rep, onehot, mask, prob, protos = _contrast_inputs(seed)
    c, n = onehot.shape[-1], rep[..., 0].size
    rng = np.random.default_rng(50 + seed)
    draws = dict(tie=torch.from_numpy(rng.integers(0, 1 << 24, n).astype(np.int32)),
                 u1=torch.from_numpy(rng.random((c, 8)).astype(np.float32)))
    if mode == "sampled_pallas":
        draws["u"] = torch.from_numpy(rng.random((c, n)).astype(np.float32))
    calls = []
    if per_class:
        real = tcon.class_live_rows

        def recording(p_over_cnt, masked_cls, g, u=None):
            calls.append((p_over_cnt, masked_cls.long(), g, u))
            return real(p_over_cnt, masked_cls, g, u)

        def one_class(a, r, idx, wv, n_live, inv_temp):
            p_over_cnt, masked_cls, g, u = calls[0]
            k = len(calls) - 1
            calls.append(k)
            w = p_over_cnt[k][masked_cls]
            if u is None:
                return tck.weighted_exp_softsum(a, r, w, inv_temp)
            return tck.weighted_exp_softsum_stochastic(a, r, g * w, inv_temp, u[k])
        monkeypatch.setattr(tcon, "class_live_rows", recording)
        monkeypatch.setattr(tcon, "weighted_exp_softsum_live", one_class)
    x = torch.from_numpy(rep).requires_grad_(True)
    loss, new_protos = tcon.prototype_contrastive_loss(
        x, torch.from_numpy(onehot), torch.from_numpy(mask), torch.from_numpy(prob),
        torch.from_numpy(protos), **draws, num_negatives=16, negative_mode=mode)
    loss.backward()
    if per_class:
        assert calls[1:] == list(range(c))
    return loss.detach(), new_protos, x.grad


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 2])
def test_loss_equals_per_class_path(mode, seed, monkeypatch):
    batched = _loss(mode, seed, False, monkeypatch)
    per_class = _loss(mode, seed, True, monkeypatch)
    assert float(batched[0]) != 0.0
    for got, want in zip(batched, per_class):
        assert torch.equal(got, want)
