"""The port's OHEM cross-entropy and its k-th order statistic against
css_tpu's ``ohem_cross_entropy`` and ``kth_smallest_nonneg``, on the CPU.

css_tpu's function runs as it is; wrappers around its module's
``kth_smallest_nonneg`` and ``per_pixel_cross_entropy`` record the
confidences it ranks, the k-th value and the labels its kept CE sees.

Tolerances.  The k-th value and the keep threshold are exact: the port takes
them from the array css_tpu ranked and must give the same float.  The two
softmaxes differ in the last bits (up to 2.4e-7 at 19 classes), so the
port's own end-to-end threshold is exact where it is ``thresh``, +inf or a
tie of exactly representable probabilities, and within 2 f32 ulps where it
is a k-th value of random logits; the kept masks are equal and the loss
agrees to rtol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from css_tpu_torch.losses import cross_entropy as tce

# the module: css_tpu.losses re-exports a function of the same name
jce = importlib.import_module("css_tpu.losses.cross_entropy")

LOSS_RTOL = 1e-5
ULP = float(np.finfo(np.float32).eps)


def _jax_ohem(logits, labels, thresh, min_kept):
    """css_tpu's OHEM loss and what it ranked, kept and chose."""
    rec = {}
    real_kth, real_ce = jce.kth_smallest_nonneg, jce.per_pixel_cross_entropy

    def kth(flat, k):
        rec["flat"], rec["k"] = np.array(flat), k
        rec["kth"] = real_kth(flat, k)
        return rec["kth"]

    def ce(lg, lab):
        rec["kept"] = np.asarray(lab) >= 0
        return real_ce(lg, lab)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jce, "kth_smallest_nonneg", kth)
        mp.setattr(jce, "per_pixel_cross_entropy", ce)
        loss = float(jce.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), thresh,
                                            min_kept))
    num_valid = int((labels >= 0).sum())
    # css_tpu's rule (cross_entropy.py:120-122), from the k-th value it chose
    rec["thresh"] = np.float32(np.inf) if min_kept > num_valid else np.maximum(
        np.float32(rec["kth"]), np.float32(thresh))
    return loss, rec


def _port_ohem(logits, labels, thresh, min_kept):
    """The port's OHEM loss, its keep threshold and its kept mask."""
    rec = {}
    real_thresh, real_ce = tce.ohem_keep_threshold, tce.per_pixel_cross_entropy

    def keep(*args):
        rec["thresh"] = real_thresh(*args)
        return rec["thresh"]

    def ce(lg, lab):
        rec["kept"] = (lab >= 0).numpy()
        return real_ce(lg, lab)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tce, "ohem_keep_threshold", keep)
        mp.setattr(tce, "per_pixel_cross_entropy", ce)
        loss = float(tce.ohem_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                            thresh, min_kept))
    return loss, rec


def _random_case(seed, shape=(2, 24, 20), c=19, ignore=0.25):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((*shape, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, size=shape).astype(np.int32)
    labels[rng.random(shape) < ignore] = -1
    return logits, labels


def _tied_case(seed, shape=(2, 16, 16), c=4):
    """Logits drawn from 3 rows whose softmaxes are exact in f32 (exp(-200)
    is 0), so the target probabilities are 0, 0.25, 0.5 and 1, each many
    times."""
    rng = np.random.default_rng(seed)
    rows = np.array([[0, 0, 0, 0], [0, 0, -200, -200], [0, -200, -200, -200]], np.float32)
    logits = rows[rng.integers(0, 3, size=shape)]
    labels = rng.integers(0, c, size=shape).astype(np.int32)
    labels[rng.random(shape) < 0.2] = -1
    return logits, labels


def _check(logits, labels, thresh, min_kept):
    want_loss, want = _jax_ohem(logits, labels, thresh, min_kept)
    got_loss, got = _port_ohem(logits, labels, thresh, min_kept)
    np.testing.assert_array_equal(got["kept"], want["kept"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL, atol=1e-7)
    # on the very confidences css_tpu ranked, the port's k-th value and
    # threshold are css_tpu's, exactly
    flat = torch.from_numpy(want["flat"])
    assert float(tce.kth_smallest(flat, want["k"])) == float(want["kth"])
    valid = torch.from_numpy(labels >= 0).reshape(-1)
    same = tce.ohem_keep_threshold(flat, valid, thresh, min_kept)
    assert float(same) == float(want["thresh"])
    return float(got["thresh"]), float(want["thresh"]), got["kept"]


@pytest.mark.parametrize("thresh", [0.7, 0.05], ids=["thresh_wins", "kth_wins"])
@pytest.mark.parametrize("where", ["below", "equal", "above"])
def test_ohem_matches_jax_around_the_valid_count(thresh, where):
    logits, labels = _random_case(0)
    num_valid = int((labels >= 0).sum())
    min_kept = {"below": num_valid // 3, "equal": num_valid, "above": num_valid + 1}[where]
    got, want, kept = _check(logits, labels, thresh, min_kept)
    if where == "above":             # every valid pixel, decided without the k-th value
        assert got == want == float("inf") and kept.sum() == num_valid
    elif thresh == 0.7 and where == "below":
        assert got == want == np.float32(0.7)
    else:                            # a k-th value of the port's own softmax
        assert got >= thresh and abs(got - want) <= 2 * ULP * want
        assert kept.sum() >= (min_kept if where == "below" else 1)


@pytest.mark.parametrize("min_kept", [1, 40, 200, 10_000])
def test_ohem_with_ties_matches_jax_exactly(min_kept):
    logits, labels = _tied_case(1)
    got, want, kept = _check(logits, labels, 0.1, min_kept)
    assert got == want      # exact probabilities: both sides agree to the bit
    if min_kept == 200:     # the 200th value is a tie (0.25): every tied pixel is kept
        assert got == 0.25 and kept.sum() > 200


def test_ohem_with_every_pixel_ignored_is_zero():
    logits, labels = _random_case(2)
    labels[:] = -1
    got, want, kept = _check(logits, labels, 0.7, 100)
    assert got == want == float("inf") and not kept.any()
    assert float(tce.ohem_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        0.7, 100)) == 0.0


@pytest.mark.parametrize("k", [1, 7, 500, 960])
def test_kth_smallest_matches_jax_bisection(k):
    rng = np.random.default_rng(3)
    flat = rng.random(960, dtype=np.float32)
    flat[::3] = flat[5]                     # duplicates counted
    flat[::7] = 1.0
    want = float(jce.kth_smallest_nonneg(jnp.asarray(flat), k))
    assert float(tce.kth_smallest(torch.from_numpy(flat), k)) == want == float(np.sort(flat)[k - 1])
