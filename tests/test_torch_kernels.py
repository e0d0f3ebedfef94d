"""The port's InfoNCE negative sums (css_tpu_torch/ops/kernels/
contrastive_kernels.py) against css_tpu's Pallas kernels, run in interpret
mode on the CPU as tests/test_pallas_kernels.py runs them.

On CPU tensors the port takes the plain PyTorch versions of K1 and K2; the
CUDA kernels themselves are held against those plain versions on the card
by tests/test_torch_kernels_cuda.py.  Tolerances are the JAX tests' own
(test_pallas_kernels.py:44,63): forward rtol 2e-2, gradient rtol 5e-2 with
atol 1e-3, since both sides round the operands to bf16 and K2 rounds exp to
bf16 before its second product.
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
    assert tck.LAUNCHES == {"weighted_exp_softsum_fwd": 0, "weighted_exp_softsum_bwd": 0}


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
