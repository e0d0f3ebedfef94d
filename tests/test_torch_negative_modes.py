"""The contrastive loss's other negative modes (``sampled``, ``expected``,
``expected_pallas``) against css_tpu's ``prototype_contrastive_loss`` on the
same inputs, with the draws replayed from its key (contrastive.py:186,224,
264-265); the per-mode draws; the refusals.

The JAX loss's ``expected_pallas`` runs its Pallas kernels in interpret
mode on the CPU, as tests/test_contrastive.py:166-175 runs them; the port
its plain K1/K2.  Both take bf16 anchors and table with f32 accumulation.  Tolerances: loss and new
prototypes rtol 1e-3, the gradient on ``rep`` rtol 1e-2 against its largest
entry (bf16 operands, sums in another order, bf16 cotangents).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from css_tpu.losses import contrastive as jcon
from css_tpu.ops.pallas import contrastive_kernels as jck
from css_tpu_torch.losses import contrastive as tcon
from css_tpu_torch.train import draws as tdraws
from css_tpu_torch.train.draws import ContrastDraws
from tests.test_torch_losses import _contrast_inputs, replay_contrast
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = ("sampled", "expected", "expected_pallas")
LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """css_tpu's Pallas kernels in interpret mode (the CPU has no Mosaic)."""
    orig = jck.pl.pallas_call
    monkeypatch.setattr(jck.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def replay_contrast_mode(rng, mode, num_classes, num_queries, num_negatives, n) -> ContrastDraws:
    """The draws of prototype_contrastive_loss(..., rng, negative_mode=mode)
    for N = n pixels."""
    if mode == "sampled_pallas":
        return replay_contrast(rng, num_classes, num_queries, n)
    r_tie1, r_tie2, r_anchor, r_negcls, r_negpix = jax.random.split(rng, 5)

    def tie(key):
        return _t((jax.random.bits(key, (n,), dtype=jnp.uint32) >> jnp.uint32(8))
                  .astype(jnp.int32))
    draws = ContrastDraws(tie=tie(r_tie2),
                          u1=_t(jax.random.uniform(r_anchor, (num_classes, num_queries))))
    if mode == "sampled":
        qg = (num_classes, num_queries * num_negatives)
        draws.tie_all = tie(r_tie1)
        draws.u_cls = _t(jax.random.uniform(r_negcls, qg))
        draws.u_pix = _t(jax.random.uniform(r_negpix, qg))
    return draws


def _both(mode, seed, protos_zero=False, strong=0.97, q=8, g=16):
    rep, onehot, mask, prob, protos = _contrast_inputs(seed, protos_zero=protos_zero)
    c = onehot.shape[-1]
    key = jax.random.key(200 + seed)

    def j_loss(rep_):
        return jcon.prototype_contrastive_loss(
            rep_, jnp.asarray(onehot), jnp.asarray(mask), jnp.asarray(prob),
            jnp.asarray(protos), key, num_queries=q, num_negatives=g,
            strong_threshold=strong, negative_mode=mode)

    (want, want_protos), want_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(rep))
    draws = replay_contrast_mode(key, mode, c, q, g, rep[..., 0].size)
    rep_t = _t(rep).requires_grad_(True)
    got, got_protos = tcon.prototype_contrastive_loss(
        rep_t, _t(onehot), _t(mask), _t(prob), _t(protos), **draws.as_kwargs(),
        num_negatives=g, strong_threshold=strong, negative_mode=mode)
    got.backward()
    return (float(want), np.asarray(want_protos), np.asarray(want_grad),
            float(got.detach()), got_protos.numpy(), rep_t.grad.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,protos_zero,strong", [(0, False, 0.97), (1, True, 0.97),
                                                     (2, False, 0.6)])
def test_negative_mode_matches_jax(mode, seed, protos_zero, strong):
    want, want_protos, want_grad, got, got_protos, got_grad = _both(mode, seed, protos_zero,
                                                                    strong)
    assert want > 0 and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_protos, want_protos, rtol=LOSS_RTOL, atol=1e-6)
    scale = np.abs(want_grad).max()
    assert scale > 1e-4
    np.testing.assert_allclose(got_grad, want_grad, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)


def test_expected_modes_agree():
    """``expected_pallas`` is ``expected`` through K1/K2: the same loss to
    2e-3 (tests/test_contrastive.py:196's bound) on the same draws."""
    rep, onehot, mask, prob, protos = _contrast_inputs(4)
    draws = replay_contrast_mode(jax.random.key(9), "expected", onehot.shape[-1], 8, 16,
                                 rep[..., 0].size)
    out = [tcon.prototype_contrastive_loss(
        _t(rep), _t(onehot), _t(mask), _t(prob), _t(protos), **draws.as_kwargs(),
        num_negatives=16, negative_mode=mode)[0] for mode in ("expected", "expected_pallas")]
    assert float(out[0]) > 0
    np.testing.assert_allclose(float(out[1]), float(out[0]), rtol=2e-3)


def test_unknown_mode_and_missing_draws_raise():
    rep, onehot, mask, prob, protos = _contrast_inputs(5)
    n = rep[..., 0].size
    args = (_t(rep), _t(onehot), _t(mask), _t(prob), _t(protos))
    draws = replay_contrast_mode(jax.random.key(1), "expected", onehot.shape[-1], 8, 16, n)
    with pytest.raises(ValueError, match="unknown negative_mode"):
        tcon.prototype_contrastive_loss(*args, **draws.as_kwargs(), negative_mode="bogus")
    with pytest.raises(ValueError, match="unknown negative_mode"):
        jcon.prototype_contrastive_loss(jnp.asarray(rep), jnp.asarray(onehot),
                                        jnp.asarray(mask), jnp.asarray(prob),
                                        jnp.asarray(protos), jax.random.key(1),
                                        num_queries=8, num_negatives=16, negative_mode="bogus")
    for mode, field in (("sampled", "u_cls"), ("sampled_pallas", "u")):
        with pytest.raises(ValueError, match=field):
            tcon.prototype_contrastive_loss(*args, **draws.as_kwargs(), negative_mode=mode)
    with pytest.raises(ValueError, match="unknown negative_mode"):
        tdraws.sample_contrast_draws(torch.Generator(), "bogus", 4, 8, 16, n)


@pytest.mark.parametrize("mode", tdraws.NEGATIVE_MODES)
def test_step_draws_fill_the_modes_fields(mode):
    """Each mode's draws: the shapes its loss takes, nothing it does not;
    ``sampled_pallas`` draws from the generator what it drew before the
    other modes were ported (tie, then u1, then u)."""
    c, q, g, n = 5, 8, 16, 300
    got = tdraws.sample_contrast_draws(torch.Generator().manual_seed(3), mode, c, q, g, n)
    shapes = {f: (None if v is None else tuple(v.shape)) for f, v in got.as_kwargs().items()}
    want = {"tie": (n,), "u1": (c, q), "u": None, "tie_all": None, "u_cls": None, "u_pix": None}
    if mode == "sampled_pallas":
        want["u"] = (c, n)
        gen = torch.Generator().manual_seed(3)
        tie = torch.randint(0, 1 << 24, (n,), generator=gen, dtype=torch.int32)
        u1, u = torch.rand((c, q), generator=gen), torch.rand((c, n), generator=gen)
        assert torch.equal(got.tie, tie) and torch.equal(got.u1, u1) and torch.equal(got.u, u)
    elif mode == "sampled":
        want.update(tie_all=(n,), u_cls=(c, q * g), u_pix=(c, q * g))
    assert shapes == want
    assert got.tie.dtype == torch.int32 and int(got.tie.max()) < 1 << 24
