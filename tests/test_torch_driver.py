"""The port's driver (css_tpu_torch/{config,data,cli}, train/checkpoint.py,
models/convert.py ``load_torchvision_backbone``) against css_tpu's, on the
CPU, and the training entry point end to end on a tiny synthetic config.

Everything compared here is exact: config values with their types, the
synthetic records byte for byte, the loader's order and padding, the
converted trunk weights, and a checkpoint's tensors bit for bit.  The
``contrast_enabled=False`` step is held to the tolerances of
``tests/test_torch_train_step.py`` (stated there).
"""

import copy
import math
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

from css_tpu.config.config import _RefLoader
from css_tpu.data.datasets import CityscapesSpec as JaxCityscapesSpec
from css_tpu.data.datasets import SyntheticSpec as JaxSyntheticSpec
from css_tpu.data.loader import BatchLoader as JaxBatchLoader
from css_tpu.data.loader import InfiniteLoader as JaxInfiniteLoader
from css_tpu.data.splits import read_split_lists as jax_read_split_lists
from css_tpu.models import build_model as jax_build_model
from css_tpu.models.convert import convert_resnet_backbone
from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.config import CONFIG_DIR, Config, dump_config, load_config
from css_tpu_torch.config.config import dump_yaml, parse_yaml
from css_tpu_torch.losses import cross_entropy as ohem_module
from css_tpu_torch.data import (BatchLoader, CityscapesSpec, InfiniteLoader, SyntheticSpec,
                                VOCSpec, read_split_lists)
from css_tpu_torch.models.convert import from_jax_variables, load_torchvision_backbone
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.train.checkpoint import load_prototypes, restore_checkpoint, save_checkpoint
from css_tpu_torch.train.state import create_train_state
from tests.test_torch_train_step import LIVE_UNSUP, _assert_step, _run
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("VOC_config_baseline.yaml", "CityScapes_config_baseline.yaml")

TUPLE_YAML = """\
# a reference-style config with tuples
Dataset:
  crop_size: !!python/tuple [321, 321]
  scale_size: !!python/tuple
  - 0.5
  - 2.0
  canvas_size:
  - 512
  - 512
  data_dir: ''          # empty, quoted
  mix_mode: "cutmix"
Optim:
  lr: 1.0e-2
  weight_decay: 1e-4
  momentum: .9
  nesterov: yes
  schedule: ~
  steps: 0x10
"""


def _same(a, b):
    """Equal values of equal types, recursively (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _tiny_cfg(save_dir, **overrides):
    """The tiny recipe of tests/test_end_to_end.py, at batch 2."""
    cfg = {
        "Network": {"name": "DeepLabv3Plus", "num_class": 6, "backbone": "tiny",
                    "output_dim": 16},
        "EMA": {"alpha": 0.99},
        "Optim": {"lr": 6.4e-3, "weight_decay": "5e-4"},
        "Lr_Scheduler": {"power": 0.9, "min_lr": 1.0e-4},
        "Dataset": {"name": "Synthetic", "data_dir": "", "txt_dir": "", "num_labels": 8,
                    "batch_size": 2, "crop_size": [32, 32], "scale_size": [0.5, 1.5],
                    "mix_mode": "cutmix", "canvas_size": [40, 40]},
        "Training_Setting": {"epoch": 2, "save_dir": str(save_dir)},
        "Seed": 3407,
        "Loss": {"is_available": True, "warm_up": 0, "un_threshold": 0.97,
                 "strong_threshold": 0.97, "weak_threshold": 0.7, "temp": 0.5,
                 "num_queries": 8, "num_negatives": 16, "alpha": 0.99},
        "Ramp_Scheduler": {"begin_epoch": 0, "max_epoch": 200, "max_value": 1.0,
                           "min_value": 0, "ramp_mult": -5.0},
        "Distributed": {"world_size": 1, "mix_partner": "reference"},
    }
    for path, value in overrides.items():
        Config(cfg).set(path, value)
    return cfg


def _tiny_yaml(tmp_path, **overrides):
    path = tmp_path / "tiny.yaml"
    path.write_text(dump_yaml(_tiny_cfg(tmp_path / "ckpt", **overrides)))
    return str(path)


def _train(config, job, *flags):
    """run_training("ori") through the entry point's own parser, on the CPU."""
    args = entries.ori_pseudo_parser().parse_args(
        ["--config", config, "--job_name", job, "--device", "cpu", "--num_labels", "4",
         *flags])
    return train_main.run_training("ori", args)


# ------------------------------------------------------------------ config ----

@pytest.mark.parametrize("name", YAMLS + ("tuples",))
def test_config_reader_matches_pyyaml(name):
    text = TUPLE_YAML if name == "tuples" else open(
        os.path.join(REPO, "css_tpu", "config", name)).read()
    want = yaml.load(text, Loader=_RefLoader)
    got = parse_yaml(text)
    assert _same(got, want), (got, want)
    if name == "tuples":
        assert got["Dataset"]["crop_size"] == (321, 321)
        assert got["Optim"]["weight_decay"] == "1e-4"     # no dot: a string in YAML 1.1
    else:
        assert got["Optim"]["weight_decay"] == "5e-4"
        assert isinstance(got["Optim"]["lr"], float)


@pytest.mark.parametrize("name", YAMLS)
def test_port_yaml_copies_parse_equal_to_css_tpu(name):
    port = load_config(os.path.join(CONFIG_DIR, name)).data
    with open(os.path.join(REPO, "css_tpu", "config", name)) as f:
        assert _same(port, yaml.load(f.read(), Loader=_RefLoader))


def test_dump_config_round_trip(tmp_path):
    cfg = load_config(os.path.join(CONFIG_DIR, "VOC_config_baseline.yaml"))
    extra = {"Extra.none": None, "Extra.tuple": (1, 2.5, "x"), "Extra.tiny": 1e-5,
             "Extra.empty": "", "Extra.colon": "a: b", "Extra.quote": "it's",
             "Extra.boolish": "on", "Extra.flag": False, "Extra.big": 2 ** 40,
             "Extra.dict": {}}
    for key, value in extra.items():
        cfg.set(key, value)
    path = dump_config(cfg, str(tmp_path / "snap"))
    want = copy.deepcopy(cfg.data)
    want["Extra"]["tuple"] = [1, 2.5, "x"]      # tuples are written as lists
    assert _same(load_config(path).data, want)
    with open(path) as f:
        assert _same(yaml.safe_load(f), want)   # and PyYAML reads the same


def test_config_reader_refuses_what_it_cannot_read():
    for text in ("a: &x 1\n", "a: |\n  text\n", "a:\n  - [1, [2]]\n", "a: 2024-01-01\n",
                 "a: !!str 1\n", "a:\n- b: 1\n"):
        with pytest.raises(ValueError, match="line"):
            parse_yaml(text)


# -------------------------------------------------------------------- data ----

@pytest.mark.parametrize("sample_id,canvas,image_hw", [
    ("l0", (40, 40), None), ("u17", (64, 48), None), ("v3", (33, 61), (20, 30))])
def test_synthetic_records_match_css_tpu(sample_id, canvas, image_hw):
    got = SyntheticSpec(num_classes=21, canvas_hw=canvas, image_hw=image_hw).load(sample_id)
    want = JaxSyntheticSpec(num_classes=21, canvas_hw=canvas, image_hw=image_hw).load(sample_id)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cache", [False, True], ids=["decode", "cached"])
def test_file_specs_decode_like_css_tpu(tmp_path, cache):
    """Cityscapes PNGs load as css_tpu loads them (lossless); a VOC JPEG as
    PIL decodes it (css_tpu may use its native JPEG decoder here); with a
    cache directory the second load comes from the cache, unchanged."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    lab = rng.integers(0, 19, (20, 30)).astype(np.uint8)
    lab[:3] = 255
    sid = "aachen_000000_000019_leftImg8bit"
    for sub, name, array in (("leftImg8bit", f"{sid}.png", img),
                             ("gtFine", "aachen_000000_000019_gtFine_trainIds.png", lab)):
        (tmp_path / sub / "val" / "aachen").mkdir(parents=True, exist_ok=True)
        Image.fromarray(array).save(tmp_path / sub / "val" / "aachen" / name)
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "SegmentationClassAug").mkdir()
    Image.fromarray(img).save(tmp_path / "JPEGImages" / "v1.jpg", quality=95)
    Image.fromarray(lab).save(tmp_path / "SegmentationClassAug" / "v1.png")
    Image.fromarray(img[:5]).save(tmp_path / "JPEGImages" / "v2.jpg", quality=95)   # no label

    cache_dir = str(tmp_path / "cache") if cache else None
    city = CityscapesSpec(root=str(tmp_path), mode="val", canvas_hw=(32, 40),
                          cache_dir=cache_dir)
    want = JaxCityscapesSpec(root=str(tmp_path), mode="val", canvas_hw=(32, 40)).load(sid)
    voc = VOCSpec(root=str(tmp_path), canvas_hw=(24, 32), cache_dir=cache_dir)
    with Image.open(tmp_path / "JPEGImages" / "v1.jpg") as im:
        jpeg = np.asarray(im.convert("RGB"))
    for _ in range(2):
        for g, w in zip(city.load(sid), want):
            np.testing.assert_array_equal(g, w)
        image, label, hw = voc.load("v1")
        np.testing.assert_array_equal(image[:20, :30], jpeg)
        assert not image[20:].any() and not image[:, 30:].any()
        np.testing.assert_array_equal(label[:20, :30], lab)
        assert (label[20:] == 255).all() and list(hw) == [20, 30]
        assert (voc.load("v2")[1] == 255).all()
    if cache:
        assert sorted(os.listdir(cache_dir)) == sorted(["val_" + sid + ".rawc", "v1.rawc",
                                                        "v2.rawc"])


@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shards", [1, 2])
def test_batch_loader_order_and_padding_match_css_tpu(shuffle, shards):
    ids = [f"s{i}" for i in range(11)]
    kw = dict(batch_size=3, seed=5, shuffle=shuffle, drop_last=shuffle, num_shards=shards,
              num_workers=2)
    spec = SyntheticSpec(num_classes=5, canvas_hw=(8, 8))
    jspec = JaxSyntheticSpec(num_classes=5, canvas_hw=(8, 8))
    for index in range(shards):
        ours = BatchLoader(spec, ids, shard_index=index, **kw)
        theirs = JaxBatchLoader(jspec, ids, shard_index=index, **kw)
        try:
            for epoch in (0, 1):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert ours._shard_ids() == theirs._shard_ids()
                assert len(ours) == len(theirs) > 0
                got, want = list(ours), list(theirs)
                assert len(got) == len(want) == len(ours)
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for key in g:
                        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                if not shuffle:   # the eval pad row (11 ids, 2 shards) is masked
                    want_valid = {(1, 0): 11, (2, 0): 6, (2, 1): 5}[shards, index]
                    assert sum(int(b["valid"].sum()) for b in got) == want_valid
            stream, jstream = InfiniteLoader(ours, 1), JaxInfiniteLoader(theirs, 1)
            for _ in range(2 * len(ours) + 1):
                np.testing.assert_array_equal(next(stream)["image"], next(jstream)["image"])
        finally:
            ours.close()


def test_read_split_lists_matches_css_tpu(tmp_path):
    root = tmp_path / "92" / "3407"
    root.mkdir(parents=True)
    (root / "labeled_filename.txt").write_text("a\nb\n\n")
    (root / "unlabeled_filename.txt").write_text("c\n  \nd\ne\n")
    (root / "valid_filename.txt").write_text("f")
    got = read_split_lists(str(tmp_path), 92, 3407)
    assert got == jax_read_split_lists(str(tmp_path), 92, 3407)
    assert got == (["a", "b"], ["c", "d", "e"], ["f"])


# ------------------------------------------------------ weights, checkpoint ----

def _torchvision_resnet101(seed=0):
    """A random state dict under torchvision's resnet101() names and shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g)

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for layer, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3)), 1):
        for b in range(blocks):
            p = f"layer{layer}.{b}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_load_torchvision_backbone_matches_css_tpu():
    sd = _torchvision_resnet101()
    jbackbone = jax_build_model(num_classes=21, backbone="resnet101").backbone
    params, stats = convert_resnet_backbone({k: v.numpy() for k, v in sd.items()}, jbackbone)
    want = from_jax_variables(params, stats)
    model = build_model(21, 256, "resnet101")
    got = load_torchvision_backbone(sd, model)
    assert got.keys() == want.keys() == model.backbone.state_dict().keys()
    loaded = model.backbone.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
        assert torch.equal(loaded[key], value), key
    del sd["layer3.22.bn3.running_var"]
    with pytest.raises(KeyError, match="layer3.22.bn3.running_var"):
        load_torchvision_backbone(sd, model)


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    kw = dict(base_lr=1e-2, weight_decay=5e-4, total_steps=100, device="cpu")
    state = create_train_state(build_model(6, 16, "tiny", seed=0), 6, 16, **kw)
    image = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    for _ in range(2):   # momentum buffers and BN running stats move
        pred, rep = state.model(image)
        state.optimizer.zero_grad()
        (pred.square().mean() + rep.mean()).backward()
        state.optimizer.step()
    state.prototypes = torch.randn(6, 16)
    state.step = 7
    path = str(tmp_path / "sub" / "last_model")
    save_checkpoint(path, state, epoch=3, miou=0.25)
    assert os.listdir(tmp_path / "sub") == ["last_model"]      # no temporary file left

    other = create_train_state(build_model(6, 16, "tiny", seed=1), 6, 16, **kw)
    other, epoch, miou = restore_checkpoint(path, other)
    assert (other.step, epoch, miou) == (7, 3, 0.25)
    assert torch.equal(other.prototypes, state.prototypes)
    for a, b in ((state.model, other.model), (state.teacher, other.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    mom = [state.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]
    got = [other.optimizer.state[p]["momentum_buffer"] for p in other.model.parameters()]
    assert len(mom) == len(got) > 0 and all(torch.equal(x, y) for x, y in zip(mom, got))

    third = create_train_state(build_model(6, 16, "tiny", seed=2), 6, 16, **kw)
    assert torch.equal(load_prototypes(path, third).prototypes, state.prototypes)
    assert third.step == 0


# ------------------------------------------------------------------ driver ----

def test_run_training_ori_end_to_end(tmp_path):
    config = _tiny_yaml(tmp_path)
    result = _train(config, "e2e", "--synthetic", "--total_iter", "4")
    assert result["steps"] == 4 and not result["preempted"]
    assert np.isfinite(result["best_miou"]) and result["steps_per_sec"] > 0
    job = tmp_path / "ckpt" / "e2e"
    log = (job / "train.log").read_text()
    assert log.count("* mIoU") == 2                    # one eval per epoch, 2 epochs
    snapshot = load_config(str(job / "config.yaml")).data
    want = _tiny_cfg(tmp_path / "ckpt")
    want["Dataset"]["name"] = "Synthetic"              # --synthetic
    assert _same(snapshot, want)
    state = create_train_state(build_model(6, 16, "tiny"), 6, 16, base_lr=1e-2,
                               weight_decay=0.0, total_steps=4, device="cpu")
    _, epoch, miou = restore_checkpoint(str(job / "last_model"), state)
    assert (state.step, epoch, miou) == (4, 2, result["best_miou"])
    assert (job / "best_model").exists()


def _flat(draws):
    out = []
    for part in (draws.l_aug, draws.u_crop, draws.t_crop, draws.u_aug, draws.mix,
                 draws.contrast):
        out += [v for v in part.as_kwargs().values() if v is not None]
    return out


def test_resume_continues_with_the_same_draws(tmp_path, monkeypatch):
    drawn = []
    sample = train_main.sample_step_draws
    monkeypatch.setattr(train_main, "sample_step_draws",
                        lambda *a, **kw: drawn.append(sample(*a, **kw)) or drawn[-1])
    config = _tiny_yaml(tmp_path)
    full = _train(config, "full", "--synthetic", "--total_iter", "8", "--max_steps", "4")
    assert full["steps"] == 4
    whole, drawn[:] = list(drawn), []
    first = _train(config, "part", "--synthetic", "--total_iter", "8", "--max_steps", "2")
    last = str(tmp_path / "ckpt" / "part" / "last_model")
    second = _train(config, "part", "--synthetic", "--total_iter", "8", "--max_steps", "4",
                    "--resume", last)
    assert (first["steps"], second["steps"]) == (2, 4)
    assert "resumed from" in (tmp_path / "ckpt" / "part" / "train.log").read_text()
    assert len(drawn) == len(whole) == 4
    for s, (a, b) in enumerate(zip(whole, drawn)):
        assert all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b))), f"step {s}"
    assert not torch.equal(_flat(whole[0])[0], _flat(whole[1])[0])


def test_sigterm_writes_last_model_and_returns(tmp_path, monkeypatch):
    assert threading.current_thread() is threading.main_thread()
    make = train_main.make_train_step

    def make_and_signal(cfg):
        step = make(cfg)

        def signalling(state, *args):
            out = step(state, *args)
            os.kill(os.getpid(), signal.SIGTERM)
            return out
        return signalling

    monkeypatch.setattr(train_main, "make_train_step", make_and_signal)
    before = signal.getsignal(signal.SIGTERM)
    result = _train(_tiny_yaml(tmp_path), "term", "--synthetic", "--total_iter", "4")
    assert signal.getsignal(signal.SIGTERM) == before
    assert result["preempted"] and result["steps"] == 1
    job = tmp_path / "ckpt" / "term"
    assert not (job / "best_model").exists()
    state = create_train_state(build_model(6, 16, "tiny"), 6, 16, base_lr=1e-2,
                               weight_decay=0.0, total_steps=4, device="cpu")
    _, epoch, _ = restore_checkpoint(str(job / "last_model"), state)
    assert (state.step, epoch) == (1, 0)      # the epoch replays on resume


def test_labeled_split_smaller_than_a_batch_fails_fast(tmp_path):
    split = tmp_path / "splits" / "1" / "3407"
    split.mkdir(parents=True)
    for name, ids in (("labeled", "a\n"), ("unlabeled", "b\nc\nd\n"), ("valid", "e\n")):
        (split / f"{name}_filename.txt").write_text(ids)
    config = _tiny_yaml(tmp_path, **{"Dataset.name": "VOC",
                                     "Dataset.txt_dir": str(tmp_path / "splits")})
    with pytest.raises(ValueError, match="labeled split too small"):
        _train(config, "tiny_split", "--num_labels", "1")


@pytest.mark.parametrize("key,override,flags", [
    ("strategy", {}, ()),
    ("Training_Setting.aug_quantize", {"Training_Setting.aug_quantize": True}, ()),
    ("Loss.negative_mode", {"Loss.negative_mode": "expected_pallas"}, ()),
    ("Dataset.mix_mode", {"Dataset.mix_mode": "classmix"}, ()),
], ids=lambda v: v if isinstance(v, str) else None)
def test_driver_refuses_what_is_not_ported_by_name(tmp_path, monkeypatch, key, override, flags):
    """Every setting the driver once refused is ported: each trains a step
    through the entry points, as the YAML says (``mix``, and ``cross`` with
    ClassMix, with the uint8 law and the ``sampled`` negatives, as once
    refused under them; ``ori`` in each other negative mode and with the
    uint8 law); what nobody can run, an unknown strategy or negative mode,
    raises ValueError before any work."""
    seen = _probe_run(monkeypatch)
    if key in ("strategy", "Dataset.mix_mode"):
        config = _tiny_yaml(tmp_path, **override, **{"Training_Setting.aug_quantize": True,
                                                     "Loss.negative_mode": "sampled"})
        for strategy in (("mix",) if key == "strategy" else ("cross",)):
            result = train_main.run_training(strategy, entries.mix_label_parser().parse_args(
                ["--config", config, "--device", "cpu", "--synthetic", "--num_labels", "4",
                 "--total_iter", "2", "--max_steps", "1", "--job_name", strategy]))
            assert result["steps"] == 1
            cfg = seen["cfg"]
            assert (cfg.strategy, cfg.aug_quantize, cfg.negative_mode) == (strategy, True,
                                                                          "sampled")
            assert cfg.mix_mode == override.get("Dataset.mix_mode", "cutmix")
        with pytest.raises(ValueError, match="unknown strategy"):
            train_main.run_training("bogus", entries.ori_pseudo_parser().parse_args(
                ["--config", config, "--device", "cpu", "--synthetic"]))
    else:
        # the negative-mode case trains each of the modes once refused
        values = (("expected", "expected_pallas", "sampled") if key == "Loss.negative_mode"
                  else (override[key],))
        name = key.split(".")[1]
        for value in values:
            run_dir = tmp_path / f"run_{value}"
            run_dir.mkdir()
            config = _tiny_yaml(run_dir, **{key: value})
            result = _train(config, "opt_in", "--synthetic", "--total_iter", "2",
                            "--max_steps", "1", *flags)
            assert result["steps"] == 1
            assert getattr(seen["cfg"], name) == value
        (tmp_path / "bogus").mkdir()
        bogus = _tiny_yaml(tmp_path / "bogus", **{"Loss.negative_mode": "bogus"})
        with pytest.raises(ValueError, match="unknown negative_mode"):
            _train(bogus, "bogus", "--synthetic")
        assert not (tmp_path / "bogus" / "ckpt").exists()      # refused before any work
    assert all(np.isfinite(list(m.values())).all() for m in seen["metrics"])


def _probe_run(monkeypatch):
    """Records what the driver builds (state, step config), each step's
    starting step count and prototypes, draws and losses, and counts OHEM
    thresholds and the student's BN groups."""
    seen = {"starts": [], "draws": [], "metrics": [], "ohem": 0, "bn_groups": set()}
    build, make = train_main._build_state_and_steps, train_main.make_train_step

    def building(*args, **kw):
        out = build(*args, **kw)
        seen["state"], seen["cfg"] = out[0], out[1]
        out[0].model.register_forward_pre_hook(
            lambda mod, args, kw: seen["bn_groups"].add(kw.get("bn_groups", 1)),
            with_kwargs=True)
        return out

    def making(cfg):
        step = make(cfg)

        def probed(state, batch, draws, *args):
            seen["starts"].append((state.step, state.prototypes.clone()))
            seen["draws"].append(draws)
            state, metrics = step(state, batch, draws, *args)
            seen["metrics"].append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return probed

    real_keep = ohem_module.ohem_keep_threshold

    def keep(*args):
        seen["ohem"] += 1
        return real_keep(*args)

    monkeypatch.setattr(train_main, "_build_state_and_steps", building)
    monkeypatch.setattr(train_main, "make_train_step", making)
    monkeypatch.setattr(ohem_module, "ohem_keep_threshold", keep)
    return seen


@pytest.mark.parametrize("key,override", [
    ("Loss.sup_loss", {"Loss.sup_loss": "ohem", "Loss.ohem_min_kept_per_image": 64}),
    ("Network.backbone", {"Network.backbone": "tiny_stem"}),
    ("Training_Setting.fused_forward", {"Training_Setting.fused_forward": True}),
    ("Network.remat", {"Network.remat": [2], "Network.remat_policy": "save_mid"}),
])
def test_driver_runs_the_cityscapes_settings(tmp_path, monkeypatch, key, override):
    """Each setting the driver refused before the Cityscapes recipe was
    ported now trains a step, and reaches the step as the YAML says."""
    seen = _probe_run(monkeypatch)
    result = _train(_tiny_yaml(tmp_path, **override), "city", "--synthetic",
                    "--total_iter", "2", "--max_steps", "1")
    assert result["steps"] == 1 and all(np.isfinite(list(seen["metrics"][0].values())))
    cfg, trunk = seen["cfg"], seen["state"].model.backbone
    rows = seen["draws"][0].contrast.tie.shape[0]
    if key == "Loss.sup_loss":
        assert (cfg.sup_loss, cfg.ohem_min_kept_per_image, seen["ohem"]) == ("ohem", 64, 1)
    else:
        assert cfg.sup_loss == "ce" and seen["ohem"] == 0
    # the contrastive draws are sized from the model: 9 x 9 at 32 under the deep stem
    assert trunk.deep_stem == (key == "Network.backbone")
    assert rows == 2 * 2 * (81 if trunk.deep_stem else 64)
    assert cfg.fused_forward == (key == "Training_Setting.fused_forward")
    assert seen["bn_groups"] == ({2} if cfg.fused_forward else {1})   # the student's passes
    assert (trunk.remat, trunk.remat_policy) == (
        ((2,), "save_mid") if key == "Network.remat" else (False, "nothing"))


@pytest.mark.parametrize("setting,want", [({"Network.remat": 2}, (2,)),
                                          ({"Network.remat": [1, 3]}, (1, 3)),
                                          ({"Network.remat": False, "Dataset.crop_size": [769, 769]},
                                           False),
                                          ({"Dataset.crop_size": [512, 512]}, False),
                                          ({"Dataset.crop_size": [513, 513]}, True)])
def test_remat_setting_reads_as_css_tpu_does(tmp_path, setting, want):
    """``Network.remat``: one stage index (not ``bool(2)``), a list of
    indices or a bool; unset, on for crops above 512^2."""
    cfg = load_config(_tiny_yaml(tmp_path, **setting))
    args = entries.ori_pseudo_parser().parse_args(["--device", "cpu", "--total_iter", "4"])
    state, _, _, _ = train_main._build_state_and_steps(cfg, args, torch.device("cpu"))
    assert state.model.backbone.remat == want


def test_is_available_false_turns_the_contrast_off(tmp_path):
    cfg = load_config(_tiny_yaml(tmp_path, **{"Loss.is_available": False}))
    args = entries.ori_pseudo_parser().parse_args(["--device", "cpu", "--total_iter", "4"])
    _, step_cfg, _, _ = train_main._build_state_and_steps(cfg, args, torch.device("cpu"))
    assert step_cfg.contrast_enabled is False


def test_contrast_disabled_step_matches_jax():
    ((jm, jstate, tm, tstate),) = list(_run(1, contrast_enabled=False, **LIVE_UNSUP))
    assert float(jm["contrast"]) == float(tm["contrast"]) == 0.0
    assert float(jm["unsup"]) > 0
    _assert_step(jm, jstate, tm, tstate)
    assert not tstate.prototypes.any()       # kept: still the initial zeros


def test_entry_point_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for strategy in ("ori", "mix", "cross"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entries.main([strategy, "--config", _tiny_yaml(tmp_path), "--synthetic"])
    assert not (tmp_path / "ckpt").exists()
    with pytest.raises(SystemExit, match="usage"):
        entries.main(["pseudo", "--config", _tiny_yaml(tmp_path)])


def test_module_entry_point_trains_on_the_cpu(tmp_path):
    """``python -m css_tpu_torch.cli.entries ori ... --device cpu`` in a
    fresh interpreter: it trains, evaluates and checkpoints, and never
    imports JAX."""
    config = _tiny_yaml(tmp_path)
    probe = ("import runpy, sys; sys.argv = ['entries'] + sys.argv[1:]; "
             "runpy.run_module('css_tpu_torch.cli.entries', run_name='__main__'); "
             "assert 'jax' not in sys.modules, 'the port imported jax'")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", probe, "ori", "--config", config, "--synthetic", "--device",
         "cpu", "--num_labels", "4", "--total_iter", "2", "--job_name", "cli"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'steps': 2" in out.stdout and "'preempted': False" in out.stdout
    job = tmp_path / "ckpt" / "cli"
    assert {"train.log", "config.yaml", "best_model", "last_model"} <= set(os.listdir(job))
