"""The port's driver over 2 gloo ranks on the CPU: ``--num_devices 2
--device cpu`` through the entry point's parser on the tiny synthetic
recipe, resumes across world sizes, the launcher's refusals and the
SIGTERM poll across ranks.

What is held exactly: the ranks' final states (a SHA-256 of each rank's
student, teacher, momentum and prototypes), the step and the prototypes a
resumed run starts from (bit for bit against the checkpoint), which rank
writes files, and the steps at which the ranks stop after SIGTERM.
"""

import os
import socket

import numpy as np
import pytest
import torch

from css_tpu_torch import parallel
from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.parallel import mesh
from css_tpu_torch.train.checkpoint import restore_checkpoint
from css_tpu_torch.train.state import create_train_state
from tests import _torch_dist_worker as worker
from tests.test_torch_driver import _tiny_yaml

TIMEOUT_S = 300.0


@pytest.fixture(autouse=True)
def _small_ranks(monkeypatch):
    """Spawned ranks take 2 threads each and give up on a collective after
    ``TIMEOUT_S``, so a hang fails instead of holding the suite."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(worker.THREADS))
    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT_S", TIMEOUT_S)


def _args(config, job, *flags):
    return entries.ori_pseudo_parser().parse_args(
        ["--config", config, "--job_name", job, "--device", "cpu", "--synthetic",
         "--num_labels", "4", *flags])


def _first_step_probe(monkeypatch):
    """Records the (step, prototypes) the first step of a run receives."""
    starts = []
    make = train_main.make_train_step

    def making(cfg):
        step = make(cfg)

        def probed(state, *a):
            starts.append((state.step, state.prototypes.clone()))
            return step(state, *a)
        return probed
    monkeypatch.setattr(train_main, "make_train_step", making)
    return starts


def _saved(path):
    state = create_train_state(build_model(6, 16, "tiny"), 6, 16, base_lr=1e-2,
                               weight_decay=0.0, total_steps=8, device="cpu")
    state, epoch, _ = restore_checkpoint(path, state)
    return state, epoch


def test_two_ranks_train_evaluate_and_resume_at_one(tmp_path, monkeypatch):
    """2 ranks, global batch 2 x 2: one step an epoch, an eval after each;
    then the checkpoint resumes on one process, at its step, with its
    prototypes."""
    config = _tiny_yaml(tmp_path)
    result = train_main.run_training("ori", _args(config, "dp", "--num_devices", "2",
                                                  "--total_iter", "4", "--max_steps", "2"))
    assert result["steps"] == 2 and not result["preempted"] and result["world_size"] == 2
    assert np.isfinite(result["best_miou"])
    first, second = result["state_sha256"]
    assert first == second                              # the ranks end bit-equal
    job = tmp_path / "ckpt" / "dp"
    assert sorted(os.listdir(job)) == ["best_model", "config.yaml", "last_model", "tb",
                                       "train.log"]
    log = (job / "train.log").read_text()
    # rank 0 alone logs: one header line, one eval line per epoch
    assert log.count("device=cpu") == 1 and "per rank, 2 ranks" in log
    assert log.count("* mIoU") == 2
    saved, epoch = _saved(str(job / "last_model"))
    assert (saved.step, epoch) == (2, 2) and saved.prototypes.any()

    starts = _first_step_probe(monkeypatch)
    resumed = train_main.run_training("ori", _args(
        config, "dp", "--total_iter", "8", "--max_steps", "3", "--resume",
        str(job / "last_model")))
    assert resumed["steps"] == 3 and "world_size" not in resumed
    step, protos = starts[0]
    assert step == 2 and torch.equal(protos, saved.prototypes)


def test_one_rank_checkpoint_resumes_on_two_ranks_and_only_rank_0_writes(tmp_path):
    """A one-process checkpoint resumes on 2 ranks (the probed ranks record
    their first step's state and every save), both at the saved step with
    the saved prototypes; rank 0 alone dumps the config and saves."""
    config = _tiny_yaml(tmp_path)
    one = train_main.run_training("ori", _args(config, "one", "--total_iter", "4",
                                               "--max_steps", "1"))
    assert one["steps"] == 1
    last = str(tmp_path / "ckpt" / "one" / "last_model")
    saved, _ = _saved(last)
    ranks = parallel.spawn(worker.train_probed, ("ori", _args(
        config, "two", "--total_iter", "4", "--max_steps", "2", "--resume", last)),
        2, "gloo", ["cpu", "cpu"], workdir=str(tmp_path))
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        step, protos = r["start"]
        assert step == 1 and np.array_equal(protos, saved.prototypes.numpy())
        assert r["result"]["steps"] == 2
    assert ranks[0]["result"]["state_sha256"] == ranks[1]["result"]["state_sha256"]
    assert ranks[0]["dumps"] == 1 and ranks[0]["saves"][-1] == "last_model"
    assert ranks[1]["dumps"] == 0 and ranks[1]["saves"] == []
    assert (tmp_path / "ckpt" / "two" / "train.log").read_text().count("resumed from") == 1


def test_more_devices_than_cards_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spawned = []
    monkeypatch.setattr(parallel, "spawn", lambda *a, **kw: spawned.append(a))
    args = entries.ori_pseudo_parser().parse_args(
        ["--config", _tiny_yaml(tmp_path), "--synthetic", "--num_devices", "2"])
    with pytest.raises(ValueError, match="exceeds the 1 CUDA devices"):
        train_main.run_training("ori", args)
    args.num_devices = 0
    with pytest.raises(ValueError, match="at least one device"):
        train_main.run_training("ori", args)
    assert not spawned and not (tmp_path / "ckpt").exists()


def test_unported_settings_are_refused_before_any_rank_starts(tmp_path, monkeypatch):
    """The once-unported settings pass the parent's check and reach the
    spawn; a setting the step refuses (an unknown negative mode) raises
    ValueError in the parent, before any rank starts."""
    spawned = []
    monkeypatch.setattr(parallel, "spawn", lambda *a, **kw: spawned.append(a) or [{}])
    (tmp_path / "bad").mkdir()
    bad = _tiny_yaml(tmp_path / "bad", **{"Loss.negative_mode": "bogus"})
    with pytest.raises(ValueError, match="unknown negative_mode"):
        train_main.run_training("ori", _args(bad, "refused", "--num_devices", "2"))
    assert not spawned and not (tmp_path / "bad" / "ckpt").exists()
    config = _tiny_yaml(tmp_path, **{"Training_Setting.aug_quantize": True,
                                     "Loss.negative_mode": "expected_pallas"})
    train_main.run_training("ori", _args(config, "opt_in", "--num_devices", "2"))
    assert len(spawned) == 1 and spawned[0][2] == 2


def test_sigterm_on_one_rank_stops_both_at_the_next_check(tmp_path):
    """SIGTERM reaches rank 1 before step 1's poll; with a check every 3
    steps both ranks stop at step 3, not at 1 or 2, and agree at every
    step after."""
    stops = parallel.spawn(worker.sigterm_poll, (3, 8, 1, 1), 2, "gloo", ["cpu", "cpu"],
                           workdir=str(tmp_path))
    want = [False, False, False, True, False, False, True, False]
    assert stops == [want, want]


def test_torchrun_environment_joins_its_group(tmp_path, monkeypatch):
    """With torchrun's variables set, the entry point trains as that rank
    (here the one rank of a 1-rank gloo group on localhost) and leaves the
    group when it returns."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for name, value in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(name, value)
    assert parallel.launched_by_torchrun() and not parallel.is_initialized()
    result = train_main.run_training("ori", _args(_tiny_yaml(tmp_path), "torchrun",
                                                  "--total_iter", "2", "--max_steps", "1"))
    assert result["steps"] == 1 and result["world_size"] == 1
    assert len(result["state_sha256"]) == 1 and not parallel.is_initialized()
