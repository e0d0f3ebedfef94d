"""The port's ``mix`` and ``cross`` strategies against css_tpu's, on the CPU:
their ops (``label_onehot_ignore``, ``nearest_resize(convention='pil')``, the
ramps, ``class_half_mask`` and every ``mix_batch`` mode), the
representation-space similarities, the train step on the tiny trunk (same
weights, batch and draws, replayed from the JAX key chain as in
``tests/test_torch_train_step.py``), and the entry points end to end.

Tolerances.  The ops are exact, apart from the ramps (numpy's f32 ``exp``
against XLA's: rtol 1e-6, measured 1.7e-7) and the similarities (f32 sums in
another order: atol 1e-6, measured 1.5e-7; exactly 0 for zero prototypes).

The steps compare the pseudo-labels first: the label maps the teacher hands
to the mixing must agree on every pixel after one step from the same state
(measured: none of 2,048 or 4,096 differ, with zero and with random
prototypes), their confidences to atol 1e-4 (measured 2.1e-5: train-mode BN
over a batch of 2).  Then losses to rtol 2e-3 (measured 3.6e-5), BN stats
and prototypes to atol 2e-3 (1.2e-4, 4.6e-5), and parameters to 5% of the
largest entry of JAX's own update in the step (measured 0.75%).  The
parameter tolerance scales with the update because ``mix`` weights its
unsupervised loss by confident / kept pixels: with few agreeing pixels its
losses reach 50 and the tiny trunk's stem moves by 1.9 in one step.  It is
calibrated on JAX's own spread: a 1e-6 relative perturbation of the initial
parameters moves JAX's step by up to 1.2% of the update, as far as the port
differs.  Along the 3-step ``cross`` trajectory that switches to the
representation space at step 1, step 0 keeps these tolerances; at step 1 an
argmax of the representation space flips on near ties (measured: 23 of 4,096
labels, JAX against its perturbed self 22), so up to 2% may differ, the
losses are held to 2e-2 (measured 5.9e-3; JAX's own spread 1.5e-4 and
5.3e-3 in two perturbations), parameters and BN stats to the ``ori``
trajectory's step-1 tolerances (measured 2.7e-3, 2.1e-2), and step 2's
losses to its 3e-2 (measured 1.4e-2; JAX's own 1.3e-2).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import css_tpu.train.train_step as jax_train_step
from css_tpu.cli.train_main import _apply_cli_shadows as jax_apply_cli_shadows
from css_tpu.config import load_config as jax_load_config
from css_tpu.models import build_model as jax_build_model
from css_tpu.ops import interpolate as jinterp
from css_tpu.ops import mixing as jmix
from css_tpu.ops import onehot as jonehot
from css_tpu.train import schedulers as jsched
from css_tpu.train.state import create_train_state as jax_create_state
from css_tpu.train.state import make_optimizer
from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.config import load_config
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.ops import interpolate as tinterp
from css_tpu_torch.ops import mixing as tmix
from css_tpu_torch.ops import onehot as tonehot
from css_tpu_torch.train import schedulers as tsched
from css_tpu_torch.train import train_step as torch_train_step
from css_tpu_torch.train.checkpoint import save_checkpoint
from css_tpu_torch.train.draws import MixDraws
from css_tpu_torch.train.state import create_train_state
from tests.test_torch_augment import _t, replay_mix
from tests.test_torch_driver import _tiny_yaml
from tests.test_torch_train_step import (B, C, CFG, CROP, D, LATE_LOSS_RTOL, LIVE_UNSUP,
                                         LOSS_RTOL, OPT, STAT_ATOL, STEP1_PARAM_ATOL,
                                         STEP1_STAT_ATOL, _assert_losses, _assert_tree, _batch, replay_step_draws)

CONF_ATOL = 1e-4
UPDATE_RTOL = 5e-2
STEP1_LOSS_RTOL = 2e-2
STEP1_LABEL_SHARE = 0.02
SIM_ATOL = 1e-6
RAMP_RTOL = 1e-6
SHIPPED_RAMP = dict(begin_epoch=0, max_epoch=200, max_value=1.0, min_value=0.0,
                    ramp_mult=-5.0)      # Ramp_Scheduler of both shipped YAMLs


# --------------------------------------------------------------------- ops ----

def test_label_onehot_ignore_matches_jax():
    labels = np.random.default_rng(0).integers(-1, 5, size=(2, 7, 9)).astype(np.int32)
    want = np.asarray(jonehot.label_onehot_ignore(jnp.asarray(labels), 5))
    got = tonehot.label_onehot_ignore(_t(labels), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[labels < 0].any() and (got.sum(-1) == (labels >= 0)).all()


@pytest.mark.parametrize("in_hw,out_hw", [((12, 20), (5, 7)), ((5, 7), (12, 20)),
                                          ((9, 9), (9, 4))])
def test_nearest_resize_pil_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).integers(-1, 21, size=(2, *in_hw)).astype(np.int32)
    for conv in ("pil", "torch"):
        want = np.asarray(jinterp.nearest_resize(jnp.asarray(x), out_hw, convention=conv))
        got = tinterp.nearest_resize(_t(x), out_hw, convention=conv).numpy()
        np.testing.assert_array_equal(got, want, err_msg=conv)
    with pytest.raises(ValueError, match="convention"):
        tinterp.nearest_resize(_t(x), out_hw, convention="cv2")


@pytest.mark.parametrize("kw", [SHIPPED_RAMP, dict(begin_epoch=2, max_epoch=40, max_value=0.5,
                                                   min_value=0.1, ramp_mult=-3.0)],
                         ids=["shipped", "offset"])
def test_ramps_match_jax(kw):
    up = {k: v for k, v in kw.items() if k != "min_value"}
    for epoch in range(kw["max_epoch"] + 12):
        got, want = tsched.rampdown_value(epoch, **kw), float(jsched.rampdown_value(epoch, **kw))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=RAMP_RTOL, err_msg=f"down {epoch}")
        np.testing.assert_allclose(tsched.ramp_up_value(epoch, **up),
                                   float(jsched.ramp_up_value(epoch, **up)),
                                   rtol=RAMP_RTOL, err_msg=f"up {epoch}")
    assert tsched.rampdown_value(0, **SHIPPED_RAMP) == 1.0
    assert tsched.rampdown_value(200, **SHIPPED_RAMP) == 0.0


def replay_classmix(rng, b, num_classes) -> MixDraws:
    """The draws of mixing.mix_batch(rng, ..., mode='classmix') over b images."""
    keys = jax.random.split(rng, b)
    return MixDraws(scores=_t(jax.vmap(lambda k: jax.random.uniform(k, (num_classes + 1,)))(keys)))


def test_class_half_mask_matches_jax():
    b, c = 6, 21
    labels = np.random.default_rng(2).integers(0, 7, size=(b, 24, 20)).astype(np.int32)
    labels[0, :3] = -1
    labels[1] = 4                       # one present label: nothing kept
    labels[2, :, :10] = -1              # two: one kept
    key = jax.random.key(5)
    draws = replay_classmix(key, b, c)
    want = np.stack([np.asarray(jmix.class_half_mask(k, jnp.asarray(lab), c))
                     for k, lab in zip(jax.random.split(key, b), labels)])
    got = tmix.class_half_mask(_t(labels), draws.scores).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and 0 < got[2].mean() < 1


@pytest.mark.parametrize("mode", ["none", "cutout", "cutmix", "classmix"])
def test_mix_batch_modes_match_jax(mode):
    """K = 2 label maps and L = 2 confidence maps, as ``cross`` hands over."""
    b, hw, c = 4, (32, 40), 5
    rng = np.random.default_rng(3)
    img = rng.random((b, 3, *hw), dtype=np.float32)
    labels = rng.integers(-1, c, size=(b, 2, *hw)).astype(np.int32)
    confs = rng.random((b, 2, *hw), dtype=np.float32)
    key = jax.random.key(17)
    want = jmix.mix_batch(key, jnp.asarray(img), jnp.asarray(labels), jnp.asarray(confs),
                          mode=mode, num_classes=c)
    draws = {"none": MixDraws(), "classmix": replay_classmix(key, b, c)}.get(
        mode, replay_mix(key, b, hw))
    got = tmix.mix_batch(_t(img), _t(labels), _t(confs), mode=mode, **draws.as_kwargs())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if mode != "none":
        assert not np.array_equal(got[0].numpy(), img)
    if mode == "cutout":   # only the first label map is ignored out in the box
        np.testing.assert_array_equal(got[1][:, 1].numpy(), labels[:, 1])


@pytest.mark.parametrize("protos", ["zero", "random"])
def test_rep_space_probs_matches_jax(protos):
    rng = np.random.default_rng(4)
    rep = rng.standard_normal((2, 5, 6, D)).astype(np.float32)
    p = (np.zeros((C, D), np.float32) if protos == "zero"
         else rng.standard_normal((C, D)).astype(np.float32))
    want = np.asarray(jax_train_step._rep_space_probs(jnp.asarray(rep), jnp.asarray(p)))
    got = torch_train_step._rep_space_probs(_t(rep), _t(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_ATOL)
    if protos == "zero":   # a uniform rep-space softmax, argmax class 0 on both sides
        assert not got.any()
        probs = torch.softmax(torch.from_numpy(got) / 0.5, dim=-1)
        assert (probs.argmax(-1) == 0).all() and torch.allclose(probs, torch.tensor(1 / C))


# -------------------------------------------------------------------- step ----

class _JaxSide:
    """One tiny JAX model and initial state, and one compiled step per
    strategy.  While a step runs (and is traced) the labels and confidences
    the teacher hands to ``mix_batch`` are recorded."""

    def __init__(self):
        self.model = jax_build_model(num_classes=C, output_dim=D, backbone="tiny")
        self.tx = make_optimizer(**OPT)
        # jitted: one compile instead of one per eager op (about 15 s saved)
        self.state0 = jax.jit(lambda key: jax_create_state(
            key, self.model, self.tx, (1, CROP, CROP, 3), num_classes=C, output_dim=D))(
                jax.random.key(0))
        self.steps, self.captured = {}, []

    def config(self, strategy):
        return jax_train_step.StepConfig(**CFG, **LIVE_UNSUP, strategy=strategy)

    def step(self, strategy, state, batch, key, weight, use_rep):
        if strategy not in self.steps:
            self.steps[strategy] = jax.jit(jax_train_step.make_train_step(
                self.model, self.tx, self.config(strategy)))
        real = jax_train_step.mix_batch

        def capturing(rng, images, labels, confs, **kw):
            jax.debug.callback(lambda l, c: self.captured.append((np.asarray(l), np.asarray(c))),
                               labels, confs)
            return real(rng, images, labels, confs, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_train_step, "mix_batch", capturing)
            out = self.steps[strategy](state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                       jnp.float32(weight), jnp.asarray(use_rep))
            jax.block_until_ready(out)
            jax.effects_barrier()
        return out


@pytest.fixture(scope="module")
def jax_side():
    return _JaxSide()


def _port_state(jax_side, prototypes):
    model = build_model(C, D, "tiny")
    model.load_state_dict(from_jax_variables(jax_side.state0.params,
                                             jax_side.state0.batch_stats), strict=True)
    state = create_train_state(model, C, D, **OPT, device="cpu")
    state.prototypes = torch.from_numpy(prototypes.copy())
    return state


def _run(jax_side, monkeypatch, strategy, schedule, prototypes=None, weight=0.5, seed=20):
    """Runs both steps once per entry of ``schedule`` (its use_rep_labels
    flags); yields after each step (jax metrics, jax state, port metrics,
    port state, the largest parameter update of JAX's step, the port's
    pseudo-labels, and how many of them differ from JAX's)."""
    if prototypes is None:
        prototypes = np.zeros((C, D), np.float32)
    jstate = jax_side.state0.replace(prototypes=jnp.asarray(prototypes))
    tstate = _port_state(jax_side, prototypes)
    tstep = torch_train_step.make_train_step(torch_train_step.StepConfig(
        **CFG, **LIVE_UNSUP, strategy=strategy))
    captured = []
    real = torch_train_step.mix_batch
    monkeypatch.setattr(torch_train_step, "mix_batch", lambda img, labels, confs, **kw: (
        captured.append((labels.numpy().copy(), confs.numpy().copy())),
        real(img, labels, confs, **kw))[1])
    key = jax.random.key(1)
    jcfg = jax_side.config(strategy)
    for i, use_rep in enumerate(schedule):
        batch = _batch(seed + i)
        jax_side.captured.clear()
        before = jstate.params
        jstate, jm = jax_side.step(strategy, jstate, batch, key, weight, use_rep)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                           replay_step_draws(key, i, jcfg, B, B), weight, use_rep)
        update = max(float(jnp.abs(a - b).max())
                     for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(before)))
        ((want_labels, want_confs),) = jax_side.captured
        got_labels, got_confs = captured[-1]
        assert got_labels.shape == want_labels.shape == (B, 1 if strategy == "mix" else 2,
                                                         CROP, CROP)
        differ = int((got_labels != want_labels).sum())
        if differ == 0:
            np.testing.assert_allclose(got_confs, want_confs, rtol=0, atol=CONF_ATOL)
        yield jm, jstate, tm, tstate, update, got_labels, differ


def _assert_close_step(jm, jstate, tm, tstate, param_atol, stat_atol=STAT_ATOL,
                       loss_rtol=LOSS_RTOL):
    """Losses, student and teacher parameters and BN stats, and prototypes
    against JAX's."""
    _assert_losses(jm, tm, rtol=loss_rtol)
    assert tstate.step == int(jstate.step)
    _assert_tree(tstate.model, jstate.params, jstate.batch_stats, param_atol, stat_atol)
    _assert_tree(tstate.teacher, jstate.ema_params, jstate.ema_batch_stats, param_atol,
                 stat_atol)
    np.testing.assert_allclose(tstate.prototypes.numpy(), np.asarray(jstate.prototypes),
                               rtol=0, atol=STAT_ATOL)


def _random_prototypes(seed=7):
    return np.random.default_rng(seed).standard_normal((C, D)).astype(np.float32)


@pytest.mark.parametrize("protos", ["zero", "random"])
def test_mix_step_matches_jax(jax_side, monkeypatch, protos):
    p = _random_prototypes() if protos == "random" else None
    ((jm, jstate, tm, tstate, update, labels, differ),) = list(
        _run(jax_side, monkeypatch, "mix", [False], p))
    assert differ == 0
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    kept = labels >= 0
    # zero prototypes: the rep space votes class 0 everywhere, so only the
    # teacher's class-0 pixels survive the agreement
    assert 0 < kept.mean() < 1 and (protos == "random" or (labels[kept] == 0).all())
    _assert_close_step(jm, jstate, tm, tstate, UPDATE_RTOL * update)


@pytest.mark.parametrize("use_rep", [False, True], ids=["logit_labels", "rep_labels"])
def test_cross_step_matches_jax(jax_side, monkeypatch, use_rep):
    ((jm, jstate, tm, tstate, update, labels, differ),) = list(
        _run(jax_side, monkeypatch, "cross", [use_rep], _random_prototypes()))
    assert differ == 0
    assert float(jm["unsup"]) > 0 and float(jm["contrast"]) > 0
    assert (labels[:, 0] != labels[:, 1]).any()      # the two label spaces differ
    _assert_close_step(jm, jstate, tm, tstate, UPDATE_RTOL * update)


def test_cross_three_step_trajectory_switches_at_step_1(jax_side, monkeypatch):
    run = _run(jax_side, monkeypatch, "cross", [False, True, True], seed=30)
    jm, jstate, tm, tstate, update, _, differ = next(run)
    assert differ == 0 and tstate.prototypes.any()    # real prototypes from step 1 on
    _assert_close_step(jm, jstate, tm, tstate, UPDATE_RTOL * update)
    jm, jstate, tm, tstate, _, labels, differ = next(run)
    assert differ <= STEP1_LABEL_SHARE * labels.size, differ
    _assert_close_step(jm, jstate, tm, tstate, STEP1_PARAM_ATOL, STEP1_STAT_ATOL,
                       loss_rtol=STEP1_LOSS_RTOL)
    jm, jstate, tm, tstate, _, _, _ = next(run)
    assert tstate.step == int(jstate.step) == 3
    _assert_losses(jm, tm, rtol=LATE_LOSS_RTOL)


# ------------------------------------------------------------------ driver ----

_PARSERS = {"ori": entries.ori_pseudo_parser, "mix": entries.mix_label_parser,
            "cross": entries.cross_label_parser}


@pytest.mark.parametrize("strategy", ["ori", "mix", "cross"])
@pytest.mark.parametrize("flags", [(), ("--strong_threshold", "0.9", "--un_threshold", "0.5",
                                        "--temp", "0.2")], ids=["defaults", "flags"])
def test_cli_shadows_match_css_tpu(tmp_path, strategy, flags):
    config = _tiny_yaml(tmp_path)
    args = _PARSERS[strategy]().parse_args(["--config", config, "--synthetic", *flags])
    cfg, jcfg = load_config(config), jax_load_config(config)
    train_main._apply_cli_shadows(cfg, args, strategy)
    jax_apply_cli_shadows(jcfg, args, strategy)
    assert cfg.data == jcfg.data
    _, step_cfg, _, _ = train_main._build_state_and_steps(cfg, args, torch.device("cpu"),
                                                          strategy)
    assert step_cfg.strategy == strategy
    assert step_cfg.temp == (0.2 if flags and strategy == "ori" else 0.5)   # Loss.temp
    assert step_cfg.rep_temp == (0.2 if flags else 0.5)
    assert step_cfg.strong_threshold == (0.9 if flags else 0.97 if strategy == "ori" else 0.8)


class _StepProbe:
    """Wraps ``train_main.make_train_step``: records each step's contrast
    weight, ``use_rep_labels`` flag and incoming prototypes; with ``fake``,
    the step only counts (for runs of many epochs)."""

    def __init__(self, monkeypatch, fake=False):
        self.calls, self.fake = [], fake
        make = train_main.make_train_step
        monkeypatch.setattr(train_main, "make_train_step", lambda cfg: self._wrap(make(cfg)))

    def _wrap(self, step):
        def probed(state, batch, draws, weight, use_rep):
            self.calls.append((weight, use_rep, state.prototypes.clone()))
            if not self.fake:
                return step(state, batch, draws, weight, use_rep)
            state.step += 1
            return state, {k: torch.zeros(()) for k in ("total", "sup", "unsup", "contrast")}
        return probed


@pytest.mark.parametrize("strategy", ["mix", "cross"])
def test_entry_point_trains_mix_and_cross_on_the_cpu(tmp_path, monkeypatch, capsys, strategy):
    """4 steps, 2 epochs: ramp weights per epoch, ``--warmup 1`` switches
    ``cross`` at epoch 1, ``--prototypes_resume`` seeds its prototypes, and
    with fewer than 50 epochs every epoch is evaluated."""
    config = _tiny_yaml(tmp_path)
    seed_ckpt = str(tmp_path / "seed_model")
    seeded = torch.randn(6, 16, generator=torch.Generator().manual_seed(0))
    state = create_train_state(build_model(6, 16, "tiny"), 6, 16, base_lr=1e-2,
                               weight_decay=0.0, total_steps=4, device="cpu")
    state.prototypes = seeded
    save_checkpoint(seed_ckpt, state, epoch=1, miou=0.5)
    extra = ["--warmup", "1", "--prototypes_resume", seed_ckpt] if strategy == "cross" else []
    probe = _StepProbe(monkeypatch)
    entries.main([strategy, "--config", config, "--synthetic", "--device", "cpu",
                  "--num_labels", "4", "--total_iter", "4", "--job_name", "e2e", *extra])
    out = capsys.readouterr().out
    assert "'steps': 4" in out and "'preempted': False" in out
    ramp = [tsched.rampdown_value(e, **SHIPPED_RAMP) for e in (0, 0, 1, 1)]
    assert [w for w, _, _ in probe.calls] == ramp and ramp[2] < 1.0
    assert [r for _, r, _ in probe.calls] == ([False, False, True, True] if strategy == "cross"
                                              else [False] * 4)
    first_protos = probe.calls[0][2]
    assert torch.equal(first_protos, seeded) if strategy == "cross" else not first_protos.any()
    job = tmp_path / "ckpt" / "e2e"
    log = (job / "train.log").read_text()
    assert log.count("* mIoU") == 2 and "* Time" not in log
    assert ("prototypes seeded from" in log) == (strategy == "cross")
    assert {"best_model", "last_model", "config.yaml"} <= set(os.listdir(job))
    snapshot = load_config(str(job / "config.yaml"))
    assert (snapshot.get("Loss.strong_threshold"), snapshot.get("Loss.rep_temp")) == (0.8, 0.5)


@pytest.mark.parametrize("strategy,flags", [("mix", ("--sche", "false")),
                                            ("cross", ("--warmup", "30"))])
def test_sparse_eval_ramp_and_warmup_over_75_epochs(tmp_path, monkeypatch, capsys, strategy,
                                                    flags):
    """css_tpu's cadence with the step and the eval stubbed: eval at epochs
    0 and 20, after epoch 25 (the last 50) and at the last; a time-only line
    otherwise."""
    probe = _StepProbe(monkeypatch, fake=True)
    evaluated = []

    def fake_evaluate(eval_step, loader, crop, num_classes, seed, epoch, device):
        evaluated.append(epoch)
        return type("CM", (), {"miou": 0.25})()

    monkeypatch.setattr(train_main, "_evaluate", fake_evaluate)
    entries.main([strategy, "--config", _tiny_yaml(tmp_path), "--synthetic", "--device", "cpu",
                  "--num_labels", "2", "--total_iter", "75", "--job_name", "sparse", *flags])
    assert "'steps': 75" in capsys.readouterr().out and len(probe.calls) == 75  # 1 an epoch
    want = [e for e in range(75) if e % 20 == 0 or e > 25]
    assert evaluated == want
    log = (tmp_path / "ckpt" / "sparse" / "train.log").read_text()
    assert [e for e in range(75) if f"Epoch:{e} * Time" in log] == sorted(
        set(range(75)) - set(want))
    weights = [w for w, _, _ in probe.calls]
    if strategy == "mix":
        assert weights == [1.0] * 75 and not any(r for _, r, _ in probe.calls)
    else:
        assert weights == [tsched.rampdown_value(e, **SHIPPED_RAMP) for e in range(75)]
        assert [r for _, r, _ in probe.calls] == [e >= 30 for e in range(75)]
