"""The Cityscapes recipe through the port's driver and entry points, on the
CPU: a tiny Cityscapes-like YAML (19 classes, OHEM by the class count, the
fused forward, the deep-stem ``tiny_stem`` trunk with remat) trains, is
evaluated, checkpoints and resumes; ``mix`` and ``cross`` run it with the
fused teacher pass; and the shipped Cityscapes YAML builds the recipe it
names (it trains on the card: ``chip_smoke.py``).
"""

import os

import numpy as np
import pytest
import torch

from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.config import CONFIG_DIR, load_config
from tests.test_torch_driver import _probe_run, _tiny_yaml

SHIPPED = os.path.join(CONFIG_DIR, "CityScapes_config_baseline.yaml")
CITY_LIKE = {"Network.num_class": 19, "Network.backbone": "tiny_stem", "Network.remat": True,
             "Training_Setting.fused_forward": True, "Loss.ohem_min_kept_per_image": 64}


def _run(strategy, config, job, *flags):
    return entries.main([strategy, "--config", config, "--synthetic", "--device", "cpu",
                         "--num_labels", "4", "--job_name", job, *flags])


def test_cityscapes_like_yaml_trains_and_resumes(tmp_path, monkeypatch, capsys):
    config = _tiny_yaml(tmp_path, **CITY_LIKE)
    seen = _probe_run(monkeypatch)
    _run("ori", config, "city", "--total_iter", "4", "--max_steps", "2")
    cfg, trunk = seen["cfg"], seen["state"].model.backbone
    assert (cfg.num_classes, cfg.sup_loss, cfg.fused_forward) == (19, "ohem", True)
    assert trunk.deep_stem and trunk.remat is True
    assert seen["ohem"] == 2 and seen["bn_groups"] == {2}
    assert [d.contrast.tie.shape[0] for d in seen["draws"]] == [2 * 2 * 9 * 9] * 2
    job = tmp_path / "ckpt" / "city"
    saved = torch.load(job / "last_model", map_location="cpu", weights_only=True)
    assert saved["step"] == 2

    first = len(seen["metrics"])
    _run("ori", config, "city", "--total_iter", "4", "--max_steps", "4",
         "--resume", str(job / "last_model"))
    assert "'steps': 4" in capsys.readouterr().out.splitlines()[-1]
    assert len(seen["metrics"]) - first == 2
    assert all(np.isfinite(list(m.values())).all() for m in seen["metrics"])
    log = (job / "train.log").read_text()
    assert "resumed from" in log and log.count("* mIoU") == 2
    step, protos = seen["starts"][first]
    assert step == 2 and torch.equal(protos, saved["prototypes"]) and protos.any()
    snapshot = load_config(str(job / "config.yaml"))
    assert snapshot.get("Network.backbone") == "tiny_stem"
    assert snapshot.get("Training_Setting.fused_forward") is True


@pytest.mark.parametrize("strategy", ["mix", "cross"])
def test_cityscapes_like_yaml_runs_the_fused_teacher(tmp_path, monkeypatch, strategy):
    """``mix`` and ``cross`` on the recipe: the teacher sees labeled and
    unlabeled images in one grouped pass."""
    seen = _probe_run(monkeypatch)
    teacher_groups = []
    build = train_main._build_state_and_steps

    def building(*args, **kw):
        out = build(*args, **kw)
        out[0].teacher.register_forward_pre_hook(
            lambda mod, args, kw: teacher_groups.append((args[0].shape[0],
                                                         kw.get("bn_groups", 1))),
            with_kwargs=True)
        return out

    monkeypatch.setattr(train_main, "_build_state_and_steps", building)
    _run(strategy, _tiny_yaml(tmp_path, **CITY_LIKE), "city", "--total_iter", "2",
         "--max_steps", "1")
    assert len(seen["metrics"]) == 1 and np.isfinite(list(seen["metrics"][0].values())).all()
    assert teacher_groups[0] == (4, 2)        # 2 labeled + 2 unlabeled, grouped
    assert all(groups == 1 for _, groups in teacher_groups[1:])   # eval


def test_shipped_cityscapes_yaml_builds_its_recipe(tmp_path):
    """The port's copy of the recipe: 19 classes, ResNet-101 at 769^2, b4+4,
    OHEM (0.7, 50,000 per image), the fused forward, no remat (the YAML
    says so), and a 193 x 193 output, so the contrastive table has
    8 * 193^2 = 297,992 rows."""
    cfg = load_config(SHIPPED)
    args = entries.ori_pseudo_parser().parse_args(["--config", SHIPPED, "--synthetic",
                                                   "--device", "cpu"])
    train_main.make_train_step(train_main._step_config(cfg, "ori", False))   # the parent's check
    state, step_cfg, _, _ = train_main._build_state_and_steps(cfg, args, torch.device("cpu"))
    assert (step_cfg.negative_mode, step_cfg.aug_quantize) == ("sampled_pallas", False)
    assert step_cfg.num_classes == 19 and step_cfg.crop_hw == (769, 769)
    assert (step_cfg.sup_loss, step_cfg.ohem_thresh, step_cfg.ohem_min_kept_per_image) == (
        "ohem", 0.7, 50000)
    assert step_cfg.fused_forward and step_cfg.scale_range == (0.5, 2.0)
    trunk = state.model.backbone
    assert not trunk.deep_stem and trunk.remat is False and trunk.output_stride == 8
    assert cfg.require("Dataset.batch_size") == 4
    assert 2 * 4 * np.prod(state.model.output_hw(step_cfg.crop_hw)) == 297_992
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entries.main(["ori", "--config", SHIPPED, "--synthetic", "--job_name", "x"])
