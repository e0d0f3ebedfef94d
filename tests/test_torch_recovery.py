"""The port's fault recovery against ``css_tpu``'s driver and on its own, on
the CPU with the tiny trunk: ``cli/train_main.py`` (``_HostRecovery``,
``_recover_and_rerun``, the eval-fault skip, the refusal over ranks) and
``train/train_step.py`` (the rollback before the commit, the consumed state
after it).

Faults are injected by patching, from inside the port's step: before the
commit by a forward hook on the student that raises once the teacher's and
the student's BatchNorm stats have moved; at or after the commit from
``ema_update``.  ``css_tpu``'s step raises ``JaxRuntimeError`` from a
wrapper, as its own driver test does.

Against ``css_tpu`` both drivers train the tiny recipe in f32 from the same
initial weights, the port's draws replayed from the JAX step's key chain.
A fault after the commit at the second step (JAX: the step and its retry
fail) restores the snapshot taken before the first step, and a fault before
the commit at the fourth attempt is retried in place.  The steps the
successful attempts start from must agree exactly ([0, 0, 1, 2]: the second
batch reruns from step 0); their losses are held to
``tests/test_torch_train_step.py``'s tolerances for the steps of a
trajectory they are: 2e-3 for the first three (two from the initial state,
one after it), 3e-2 for the last.
"""

import argparse
import os
import time
import weakref

import jax
import numpy as np
import pytest
import torch

import css_tpu.cli.train_main as jax_train_main
from css_tpu.train.train_step import StepConfig as JaxStepConfig
from css_tpu_torch import parallel
from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.models.convert import from_jax_variables
from css_tpu_torch.parallel import mesh
from css_tpu_torch.train import train_step as step_module
from css_tpu_torch.train.checkpoint import state_sha256
from tests import _torch_dist_worker as worker
from tests.test_torch_driver import _tiny_yaml, _train
from tests.test_torch_train_step import LATE_LOSS_RTOL, LOSS_RTOL, replay_step_draws
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

OOM = "CUDA out of memory. Tried to allocate 64.00 GiB (injected)"
# the unpatched functions: each _PortFaults wraps these, not an earlier wrapper
MAKE_TRAIN_STEP, EMA_UPDATE = train_main.make_train_step, step_module.ema_update


def _oom():
    return torch.cuda.OutOfMemoryError(OOM)


class _PortFaults:
    """Wraps the port's step (``train_main.make_train_step``): records the
    step each attempt starts from, each successful attempt's losses and the
    state, and raises ``error()`` from inside the attempts numbered (from 1)
    in ``before`` (a forward hook on the student: before the commit) or
    ``after`` (from ``ema_update``: after it)."""

    def __init__(self, monkeypatch, before=(), after=(), error=_oom):
        self.before, self.after, self.error = set(before), set(after), error
        self.starts, self.losses, self.raised, self.state = [], [], [], None
        # per attempt: whether a failed attempt's output was still alive when it started
        self.outputs, self.kept = [], []
        make, ema = MAKE_TRAIN_STEP, EMA_UPDATE

        def making(cfg):
            step = make(cfg)

            def faulty(state, *args):
                self.starts.append(state.step)
                self.kept.append(any(ref() is not None for ref in self.outputs))
                self.state = state
                hook = (state.model.register_forward_hook(self._raise)
                        if len(self.starts) in self.before else None)
                try:
                    state, metrics = step(state, *args)
                finally:
                    if hook is not None:
                        hook.remove()
                self.losses.append((self.starts[-1],
                                    {k: float(v) for k, v in metrics.items()}))
                return state, metrics
            return faulty

        def faulty_ema(*args, **kw):
            if len(self.starts) in self.after:
                raise self.error()
            return ema(*args, **kw)

        monkeypatch.setattr(train_main, "make_train_step", making)
        monkeypatch.setattr(step_module, "ema_update", faulty_ema)

    def _raise(self, module, inputs, output):
        self.outputs.append(weakref.ref(output[0]))
        self.raised.append(self.error())
        raise self.raised[-1]


def _log(tmp_path, job):
    return (tmp_path / "ckpt" / job / "train.log").read_text()


# ------------------------------------------------------- against css_tpu ----

def _jax_args(config, job):
    return argparse.Namespace(
        config=config, resume="", num_labels=4, total_iter=8, job_name=job,
        strong_threshold=None, weak_threshold=None, un_threshold=None, temp=None, sche=True,
        data_dir=None, txt_dir=None, synthetic=True, num_devices=1, profile_dir=None,
        max_steps=3)


def _run_jax(monkeypatch, config, fail_calls):
    """css_tpu's driver with its step raising on the calls in ``fail_calls``;
    returns (result, the steps each call started from, the successful calls'
    (step, losses), the initial variables)."""
    build = jax_train_main._build_state_and_steps
    starts, losses, init = [], [], {}

    def faulty_build(cfg, args, strategy, mesh_):
        model, state, step_cfg, train_step, eval_step = build(cfg, args, strategy, mesh_)
        init.update(params=jax.device_get(state.params),
                    batch_stats=jax.device_get(state.batch_stats), step_cfg=step_cfg)

        def wrapped(state, batch, rng, weight, use_rep):
            starts.append(int(jax.device_get(state.step)))
            if len(starts) in fail_calls:
                raise jax.errors.JaxRuntimeError("injected hardware fault")
            state, metrics = train_step(state, batch, rng, weight, use_rep)
            losses.append((starts[-1], {k: float(v) for k, v in jax.device_get(metrics).items()}))
            return state, metrics
        return model, state, step_cfg, wrapped, eval_step

    monkeypatch.setattr(jax_train_main, "_build_state_and_steps", faulty_build)
    result = jax_train_main.run_training("ori", _jax_args(config, "jax"))
    return result, starts, losses, init


def _replay_jax_start(monkeypatch, init, seed):
    """The port's driver starts from ``init``'s weights and draws each step
    as the JAX step does (its key chain, device 0 of the 1-device mesh)."""
    build = train_main._build_state_and_steps
    keys = []

    def build_from_jax(cfg, args, device, strategy="ori", distributed=False):
        state, step_cfg, train_step, eval_step = build(cfg, args, device, strategy, distributed)
        weights = from_jax_variables(init["params"], init["batch_stats"])
        state.model.load_state_dict(weights, strict=True)
        state.teacher.load_state_dict(weights, strict=True)
        return state, step_cfg, train_step, eval_step

    generator = train_main._generator

    def keyed(device, *key):
        keys.append(key)
        return generator(device, *key)

    def jax_draws(g, step_cfg, bl, bu, rep_pixels):
        base, step, rank = keys[-1]
        assert base == seed + 1
        return replay_step_draws(jax.random.key(base), step, init["step_cfg"], bl, bu, rank=rank)

    monkeypatch.setattr(train_main, "_build_state_and_steps", build_from_jax)
    monkeypatch.setattr(train_main, "_generator", keyed)
    monkeypatch.setattr(train_main, "sample_step_draws", jax_draws)


def test_recovery_matches_css_tpu(tmp_path, monkeypatch):
    config = _tiny_yaml(tmp_path, **{"Network.dtype": "float32"})
    jresult, jstarts, jlosses, init = _run_jax(monkeypatch, config, fail_calls={2, 3, 5})
    assert isinstance(init["step_cfg"], JaxStepConfig)
    assert jstarts == [0, 1, 1, 0, 1, 1, 2]

    _replay_jax_start(monkeypatch, init, seed=3407)
    faults = _PortFaults(monkeypatch, before={4}, after={2})
    result = _train(config, "port", "--synthetic", "--total_iter", "8", "--max_steps", "3")
    assert faults.starts == [0, 1, 0, 1, 1, 2]      # no retry in place of a consumed state
    assert result["steps"] == jresult["steps"] == 3
    assert [s for s, _ in faults.losses] == [s for s, _ in jlosses] == [0, 0, 1, 2]
    for i, ((_, got), (_, want)) in enumerate(zip(faults.losses, jlosses)):
        for name in ("sup", "unsup", "contrast", "total"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                       rtol=LOSS_RTOL if i < 3 else LATE_LOSS_RTOL,
                                       err_msg=f"step {i}: {name}")
    for log in (_log(tmp_path, "port"), _log(tmp_path, "jax")):
        assert "retrying once" in log
        assert "restored host recovery snapshot from epoch 0 and continuing the epoch" in log


# ------------------------------------------------------------ port only ----

def test_fault_before_commit_ends_bit_equal_to_an_unfaulted_run(tmp_path, monkeypatch):
    config = _tiny_yaml(tmp_path)
    flags = ("--synthetic", "--total_iter", "8", "--max_steps", "3")
    clean = _PortFaults(monkeypatch)
    _train(config, "clean", *flags)
    faulted = _PortFaults(monkeypatch, before={2})
    result = _train(config, "faulted", *flags)
    assert result["steps"] == 3 and faulted.starts == [0, 1, 1, 2]
    assert state_sha256(faulted.state) == state_sha256(clean.state)
    # the failed attempt's activations were freed before the retry
    assert len(faulted.outputs) == 1 and not any(faulted.kept)
    log = _log(tmp_path, "faulted")
    assert f"WARNING train step failed ({OOM}); retrying once" in log
    assert "restored host recovery snapshot" not in log


def test_persistent_fault_propagates_the_original_error(tmp_path, monkeypatch):
    faults = _PortFaults(monkeypatch, before=range(2, 100))
    with pytest.raises(torch.cuda.OutOfMemoryError, match="injected"):
        _train(_tiny_yaml(tmp_path), "stuck", "--synthetic", "--total_iter", "8")
    assert faults.starts == [0, 1, 1, 0]     # the fault, the retry, the rerun from the snapshot
    log = _log(tmp_path, "stuck")
    assert "retrying once" in log and "restored host recovery snapshot from epoch 0" in log


def test_without_a_snapshot_a_consumed_state_raises_naming_the_key(tmp_path, monkeypatch):
    config = _tiny_yaml(tmp_path, **{"Training_Setting.host_recovery": 0})
    faults = _PortFaults(monkeypatch, before={2})         # a retry needs no snapshot
    assert _train(config, "retried", "--synthetic", "--total_iter", "4")["steps"] == 4
    assert faults.starts == [0, 1, 1, 2, 3]
    faults = _PortFaults(monkeypatch, after={2})
    with pytest.raises(RuntimeError, match="Training_Setting.host_recovery") as info:
        _train(config, "consumed", "--synthetic", "--total_iter", "4")
    assert OOM in str(info.value) and isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    assert faults.starts == [0, 1] and faults.state.consumed
    with pytest.raises(RuntimeError, match="consumed"):     # the step refuses it
        step_module.make_train_step(train_main._step_config(
            train_main.load_config(config), "ori", False))(faults.state, None, None, 1.0)


def test_a_sticky_fault_brings_out_the_original_error(tmp_path, monkeypatch):
    """A sticky CUDA error refuses every later copy on the device: the
    step's rollback fails (the state is consumed) and so does the restore;
    the error that ends the run names the original fault and is caused by
    it."""
    sticky = "CUDA error: an illegal memory access was encountered (injected)"

    def refuse(*args):
        raise torch.AcceleratorError(sticky)

    faults = _PortFaults(monkeypatch, before={2}, error=lambda: torch.AcceleratorError(sticky))
    monkeypatch.setattr(step_module._BufferRollback, "restore", lambda self: False)
    monkeypatch.setattr(train_main._HostRecovery, "restore", refuse)
    with pytest.raises(RuntimeError, match="device is in an error state") as info:
        _train(_tiny_yaml(tmp_path), "sticky", "--synthetic", "--total_iter", "4")
    assert str(info.value).startswith(f"train step failed ({sticky})")
    assert "--resume" in str(info.value)
    assert info.value.__cause__ is faults.raised[0] and faults.starts == [0, 1]


def test_eval_fault_is_skipped(tmp_path, monkeypatch):
    evaluate, saves, refreshes = train_main._evaluate, [], []

    def faulty_evaluate(*args, **kw):
        if not saves:             # the first eval: nothing saved yet
            raise _oom()
        return evaluate(*args, **kw)

    save, refresh = train_main.save_checkpoint, train_main._HostRecovery.refresh
    monkeypatch.setattr(train_main, "_evaluate", faulty_evaluate)
    monkeypatch.setattr(train_main, "save_checkpoint", lambda path, state, epoch, miou: (
        saves.append((os.path.basename(path), epoch, miou)), save(path, state, epoch, miou)))
    monkeypatch.setattr(train_main._HostRecovery, "refresh", lambda self, state, epoch: (
        refreshes.append((epoch, state.step)), refresh(self, state, epoch)))
    result = _train(_tiny_yaml(tmp_path), "evalfault", "--synthetic", "--total_iter", "4")
    assert result["steps"] == 4 and result["best_miou"] >= 0
    log = _log(tmp_path, "evalfault")
    assert f"WARNING eval failed (OutOfMemoryError: {OOM}); skipping this evaluation" in log
    assert "Epoch:0 * mIoU -1.0000 Best_mIoU 0.0000" in log
    # no best_model for epoch 0; last_model keeps its cadence; the snapshot
    # is refreshed at the skipped eval too
    assert [s[:2] for s in saves] == [("last_model", 1), ("best_model", 2), ("last_model", 2)]
    assert saves[0][2] == 0.0
    assert refreshes == [(0, 0), (0, 2), (1, 4)]


def test_other_errors_are_not_retried(tmp_path, monkeypatch):
    faults = _PortFaults(monkeypatch, before={2}, error=lambda: ValueError("a bug in the step"))
    with pytest.raises(ValueError, match="a bug in the step"):
        _train(_tiny_yaml(tmp_path), "bug", "--synthetic", "--total_iter", "4")
    assert faults.starts == [0, 1]
    assert "WARNING" not in _log(tmp_path, "bug")


def test_a_fault_on_one_of_two_ranks_ends_both(tmp_path, monkeypatch):
    """Over two gloo ranks a fault is not recovered: rank 1's error names
    ``--resume`` and ``last_model``, and both ranks end (spawn raises) well
    within the collectives' timeout."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(worker.THREADS))
    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT_S", 300.0)
    args = entries.ori_pseudo_parser().parse_args(
        ["--config", _tiny_yaml(tmp_path), "--job_name", "ranks", "--device", "cpu",
         "--synthetic", "--num_labels", "4", "--total_iter", "4"])
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        parallel.spawn(worker.train_with_fault, (args, 1, str(tmp_path)), 2, "gloo",
                       ["cpu", "cpu"], workdir=str(tmp_path))
    assert time.perf_counter() - t0 < 200
    error = (tmp_path / "error1.txt").read_text()
    assert error.startswith("RuntimeError: train step failed on rank 1 of 2 (OutOfMemoryError")
    assert "--resume" in error and error.endswith(os.path.join("ranks", "last_model"))
