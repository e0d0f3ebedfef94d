"""The port's InfoNCE negative sums (css_tpu_torch/ops/kernels/
contrastive_kernels.py) against css_tpu's Pallas kernels, run in interpret
mode on the CPU as tests/test_pallas_kernels.py runs them.

On CPU tensors the port takes the plain PyTorch versions of the live-row
compaction, K1 and K2; the CUDA kernels themselves are held against those
plain versions on the card by tests/test_torch_kernels_cuda.py.  Tolerances
against JAX are the JAX tests' own (test_pallas_kernels.py:44,63): forward
rtol 2e-2, gradient rtol 5e-2 with atol 1e-3, since both sides round the
operands to bf16 and K2 rounds exp to bf16 before its second product.  The
sums over the compacted rows and the dense plain versions compute the same
f32 terms and differ only in the order of the sums (rtol 1e-5); K2's bf16
rounding of one term may flip by one bf16 step (2^-8) when its f32 value
differs in the last bit, hence atol 1e-2 * max|M| there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.ops.pallas import contrastive_kernels as jck
from css_tpu_torch.ops.kernels import contrastive_kernels as tck


@pytest.fixture(autouse=True)
def _interpret_on_cpu(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(jck.pl, "pallas_call", patched)
    yield


def _case(seed, q, d, n):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((q, d)) * 0.1).astype(np.float32)
    r = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    w = (rng.random(n) * (rng.random(n) < 0.7)).astype(np.float32)
    return a, r, w


def _both(a, r, w, inv_t=2.0):
    """(value, grad of sum(log s)) from the JAX kernel and from the port."""
    r_j = jnp.asarray(r, jnp.bfloat16)

    def f(aa):
        return jnp.sum(jnp.log(jck.weighted_exp_softsum(aa, r_j, jnp.asarray(w), inv_t)))

    s_j = np.asarray(jck.weighted_exp_softsum(jnp.asarray(a), r_j, jnp.asarray(w), inv_t))
    g_j = np.asarray(jax.grad(f)(jnp.asarray(a)))

    a_t = torch.from_numpy(a).requires_grad_(True)
    r_t = torch.from_numpy(np.array(r_j.astype(jnp.float32))).to(torch.bfloat16)
    s_t = tck.weighted_exp_softsum(a_t, r_t, torch.from_numpy(w), inv_t)
    torch.log(s_t).sum().backward()
    return (s_j, g_j), (s_t.detach().numpy(), a_t.grad.numpy())


@pytest.mark.parametrize("q,d,n,dead_tail", [
    (16, 128, 3000, False),            # the JAX forward test's case
    (8, 128, 2048, False),             # the JAX gradient test's case
    (16, 128, 4 * jck.TILE_N, True),   # dead tiles: a zero tail of half the table
    (13, 48, 500, False),              # odd Q and D
])
def test_weighted_exp_softsum_matches_jax(q, d, n, dead_tail):
    a, r, w = _case(q + d + n, q, d, n)
    if dead_tail:
        w[n // 2:] = 0.0
    (s_j, g_j), (s_t, g_t) = _both(a, r, w)
    np.testing.assert_allclose(s_t, s_j, rtol=2e-2)
    np.testing.assert_allclose(g_t, g_j, rtol=5e-2, atol=1e-3)


def test_cpu_tensors_take_the_plain_versions():
    a, r, w = _case(1, 8, 64, 300)
    tck.reset_launches()
    a_t = torch.from_numpy(a).requires_grad_(True)
    tck.weighted_exp_softsum(a_t, torch.from_numpy(r).to(torch.bfloat16),
                             torch.from_numpy(w), 2.0).sum().backward()
    assert tck.LAUNCHES == {"live_rows_compact": 0, "weighted_exp_softsum_fwd": 0,
                            "weighted_exp_softsum_bwd": 0}


def test_shape_errors_match_jax():
    r = torch.zeros((64, 256), dtype=torch.bfloat16)
    w = torch.zeros((64,))
    with pytest.raises(ValueError, match="matching"):
        tck.weighted_exp_softsum(torch.zeros((8, 100)), r, w, 2.0)
    with pytest.raises(ValueError, match=r"\[N\]"):
        tck.weighted_exp_softsum(torch.zeros((8, 256)), r, torch.zeros((63,)), 2.0)
    with pytest.raises(ValueError, match=r"lam must be \[N\]"):
        tck.weighted_exp_softsum_stochastic(torch.zeros((8, 256)), r, torch.zeros((63,)),
                                            2.0, torch.zeros((63,)))


def test_thinned_multiplicities_exact():
    rng = np.random.default_rng(5)
    lam = (rng.random(10_000) * 3.0 * (rng.random(10_000) < 0.5)).astype(np.float32)
    key = jax.random.key(21)
    want = np.asarray(jck.thinned_multiplicities(key, jnp.asarray(lam)))
    u = np.array(jax.random.uniform(key, lam.shape))   # a writable copy for torch
    got = tck.thinned_multiplicities(torch.from_numpy(u), torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "dead_tail":
        w = rng.random(n).astype(np.float32)
        w[n // 2:] = 0.0
    elif kind == "all_dead":
        w = np.zeros(n, np.float32)
    elif kind == "single":
        w = np.zeros(n, np.float32)
        w[n // 3] = 1.5
    elif kind == "all_live":
        w = (rng.random(n) + 0.5).astype(np.float32)
    else:   # thinned multiplicities scattered over the whole table, sum(lam) = 32
        lam = rng.random(n) * (64.0 / n)
        w = (np.floor(lam) + (rng.random(n) < lam - np.floor(lam))).astype(np.float32)
    return w


@pytest.mark.parametrize("kind,n", [
    ("dead_tail", 4 * tck.TILE_N), ("all_dead", 300), ("single", 1000),
    ("all_live", 129), ("scattered", 5000)])
def test_compact_live_rows_plain(kind, n):
    w = _weights(kind, n, seed=n)
    idx, wv, n_live = tck.compact_live_rows_plain(torch.from_numpy(w))
    want = np.flatnonzero(w)
    count = int(n_live[0])
    assert (idx.dtype, wv.dtype, n_live.dtype) == (torch.int32, torch.float32, torch.int32)
    assert tuple(idx.shape) == tuple(wv.shape) == (n,) and count == want.size
    np.testing.assert_array_equal(idx[:count].numpy(), want)
    np.testing.assert_array_equal(wv[:count].numpy(), w[want])
    assert not idx[count:].any() and not wv[count:].any()


@pytest.mark.parametrize("q,d,n,kind", [
    (16, 128, 4 * tck.TILE_N, "dead_tail"),
    (8, 64, 300, "all_dead"),
    (13, 48, 500, "single"),
    (13, 48, 500, "scattered"),
    (24, 256, 130, "all_live"),
])
def test_live_sums_match_dense_plain(q, d, n, kind):
    a, r, _ = _case(q + d + n, q, d, n)
    a_t = torch.from_numpy(a).to(torch.bfloat16)
    r_t = torch.from_numpy(r).to(torch.bfloat16)
    w_t = torch.from_numpy(_weights(kind, n, seed=q + n))
    comp = tck.compact_live_rows_plain(w_t)
    s = tck.softsum_live_plain(a_t, r_t, *comp, 2.0)
    m = tck.softsum_moment_live_plain(a_t, r_t, *comp, 2.0)
    assert tuple(s.shape) == (q,) and tuple(m.shape) == (q, d)
    torch.testing.assert_close(s, tck.softsum_plain(a_t, r_t, w_t, 2.0), rtol=1e-5, atol=1e-6)
    m_ref = tck.softsum_moment_plain(a_t, r_t, w_t, 2.0)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-2 * float(m_ref.abs().max()) + 1e-6)
    if kind == "all_dead":
        assert not s.any() and not m.any()


@pytest.mark.parametrize("q,d,n,kind", [
    (16, 128, 4 * jck.TILE_N, "dead_tail"),   # a dead half at the TPU's tile size
    (8, 128, 2048, "all_dead"),
    (13, 48, 500, "scattered"),               # odd Q and D
])
def test_live_sums_match_jax_kernels(q, d, n, kind):
    """s and M = dL/da / inv_temp for L = sum(s), from the Pallas kernels."""
    a, r, _ = _case(q * d + n, q, d, n)
    w = _weights(kind, n, seed=q * n)
    r_j = jnp.asarray(r, jnp.bfloat16)
    a_j = jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    s_j = np.asarray(jck.weighted_exp_softsum(a_j, r_j, jnp.asarray(w), 2.0))
    m_j = np.asarray(jax.grad(lambda aa: jnp.sum(
        jck.weighted_exp_softsum(aa, r_j, jnp.asarray(w), 2.0)))(a_j)) / 2.0

    a_t = torch.from_numpy(np.array(a_j)).to(torch.bfloat16)
    r_t = torch.from_numpy(np.array(r_j.astype(jnp.float32))).to(torch.bfloat16)
    comp = tck.compact_live_rows_plain(torch.from_numpy(w))
    s_t = tck.softsum_live_plain(a_t, r_t, *comp, 2.0).numpy()
    m_t = tck.softsum_moment_live_plain(a_t, r_t, *comp, 2.0).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=2e-2)
    np.testing.assert_allclose(m_t, m_j, rtol=5e-2, atol=1e-3)


def test_autograd_compacts_once_and_backward_reuses_it(monkeypatch):
    a, r, _ = _case(3, 8, 64, 700)
    w = torch.from_numpy(_weights("scattered", 700, seed=3))
    made, used = [], []

    def compact(w_):
        made.append(tck.compact_live_rows_plain(w_))
        return made[-1]

    def moment(a_, r_, idx, wv, n_live, inv_temp):
        used.append((idx, wv, n_live))
        return tck.softsum_moment_plain(a_, r_, w, inv_temp)

    monkeypatch.setattr(tck, "compact_live_rows", compact)
    monkeypatch.setattr(tck, "softsum_moment_live_plain", moment)
    a_t = torch.from_numpy(a).requires_grad_(True)
    r_t = torch.from_numpy(r).to(torch.bfloat16)
    torch.log(tck.weighted_exp_softsum(a_t, r_t, w, 2.0)).sum().backward()
    assert len(made) == 1 and len(used) == 1
    assert all(x is y for x, y in zip(used[0], made[0]))
    assert torch.isfinite(a_t.grad).all()
