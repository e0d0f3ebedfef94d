"""The port's ``evaluate`` and ``predict`` entry points end to end on the
CPU, on a checkpoint of a tiny synthetic run: the flags of css_tpu's CLIs,
the output format, the confusion matrix against the driver's own eval on
the same weights, sliding-window counting, and predict's files (un-padding,
downscaled inputs brought back to their size, overlays).  Matrices and
class maps are compared exactly: both sides run the same port code."""

import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from css_tpu_torch.cli import entries, evaluate_main, predict_main, train_main
from css_tpu_torch.config import load_config
from css_tpu_torch.ops.augment import normalize_imagenet, to_channel_first, to_channel_last
from css_tpu_torch.train.train_step import make_eval_step, make_sliding_eval_step
from tests.test_torch_driver import _tiny_yaml, _train
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

C = 6
CANVAS = (40, 40)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny 2-step ``ori`` run: (its YAML, its best_model)."""
    tmp = tmp_path_factory.mktemp("cli")
    config = _tiny_yaml(tmp)
    _train(config, "cli", "--synthetic", "--total_iter", "2")
    return config, str(tmp / "ckpt" / "cli" / "best_model")


def _flags_of_css_tpu(module_name, monkeypatch, capsys):
    module = __import__(module_name, fromlist=["main"])
    monkeypatch.setattr(sys, "argv", ["prog", "--help"])
    with pytest.raises(SystemExit):
        module.main()
    return set(re.findall(r"--[a-z_]+", capsys.readouterr().out))


@pytest.mark.parametrize("name", ["evaluate", "predict"])
def test_flags_are_css_tpus_and_device(name, monkeypatch, capsys):
    want = _flags_of_css_tpu(f"css_tpu.cli.{name}_main", monkeypatch, capsys)
    parser = {"evaluate": evaluate_main.evaluate_parser,
              "predict": predict_main.predict_parser}[name]()
    got = {s for s in parser._option_string_actions if s.startswith("--")}
    assert got == want | {"--device"}
    assert parser.get_default("device") == "cuda"


def _loader_eval(config, step_fn, model, full_canvas):
    """The driver's ``_evaluate`` over the validation split, eval number
    ``EVAL_INDEX``."""
    cfg = load_config(config)
    cfg.set("Dataset.name", "Synthetic")
    args = entries.ori_pseudo_parser().parse_args(["--num_labels", "4"])
    loaders = train_main._make_loaders(cfg, args, cfg.require("Dataset.batch_size"))
    try:
        return train_main._evaluate(step_fn, loaders[2], tuple(cfg.require("Dataset.crop_size")),
                                    C, cfg.get("Seed"), evaluate_main.EVAL_INDEX,
                                    torch.device("cpu"), full_canvas=full_canvas)
    finally:
        for loader in loaders:
            loader.close()


@pytest.mark.parametrize("student", [False, True], ids=["teacher", "student"])
def test_evaluate_prints_iou_and_equals_the_drivers_eval(run, capsys, student):
    config, ckpt = run
    argv = ["--config", config, "--checkpoint", ckpt, "--num_labels", "4", "--synthetic",
            "--device", "cpu"] + (["--student"] if student else [])
    cm = evaluate_main.main(argv)
    lines = capsys.readouterr().out.rstrip().splitlines()
    assert [ln.split()[:3] for ln in lines[:C]] == [["class", str(i), f"class_{i}"]
                                                    for i in range(C)]
    assert all(re.fullmatch(r"\s+class\s+\d+ \S+\s+IoU (nan|\d\.\d{4})", ln) for ln in lines[:C])
    which = "student" if student else "teacher"
    m = re.fullmatch(rf"checkpoint epoch 1 \({which}\): mIoU (\S+) \(best recorded (\S+)\)",
                     lines[C])
    assert m and float(m.group(1)) == pytest.approx(cm.miou, abs=5e-5)
    model, _, _ = evaluate_main.load_eval_model(load_config(config), ckpt, student,
                                                torch.device("cpu"))
    want = _loader_eval(config, make_eval_step(model, C), model, False)
    np.testing.assert_array_equal(cm.mat, want.mat)
    assert cm.mat.sum() > 0


@pytest.mark.parametrize("flags", [["--sliding"],
                                   ["--sliding", "--stride", "8", "--flip", "--scales", "0.75,1.0"],
                                   ["--flip", "--scales", "0.75,1.0,1.25"]],
                         ids=["sliding", "sliding-stride-tta", "crop-tta"])
def test_evaluate_sliding_and_tta(run, flags):
    config, ckpt = run
    cm = evaluate_main.main(["--config", config, "--checkpoint", ckpt, "--num_labels", "4",
                             "--synthetic", "--device", "cpu", *flags])
    model, _, _ = evaluate_main.load_eval_model(load_config(config), ckpt, False,
                                                torch.device("cpu"))
    sliding = "--sliding" in flags
    stride = (8, 8) if "8" in flags else None
    scales = tuple(float(s) for s in flags[-1].split(",")) if "--scales" in flags else (1.0,)
    step = (make_sliding_eval_step(model, C, CANVAS, (32, 32), stride, flip="--flip" in flags,
                                   scales=scales) if sliding
            else make_eval_step(model, C, flip="--flip" in flags, scales=scales))
    want = _loader_eval(config, step, model, sliding)
    np.testing.assert_array_equal(cm.mat, want.mat)
    if sliding:   # every valid label pixel of every canvas, once
        cfg = load_config(config)
        cfg.set("Dataset.name", "Synthetic")
        args = entries.ori_pseudo_parser().parse_args(["--num_labels", "4"])
        loaders = train_main._make_loaders(cfg, args, 2)
        try:
            pixels = sum(int((((b["label"] >= 0) & (b["label"] < C)) & b["valid"][:, None, None])
                             .sum()) for b in loaders[2])
        finally:
            for loader in loaders:
                loader.close()
        assert cm.mat.sum() == pixels


def test_entry_points_refuse_a_missing_checkpoint_and_default_to_the_card(run, tmp_path):
    config, ckpt = run
    for name in ("evaluate", "predict"):
        extra = ["--inputs", str(tmp_path)] if name == "predict" else []
        with pytest.raises(SystemExit, match="checkpoint not found"):
            entries.main([name, "--config", config, "--checkpoint", str(tmp_path / "none"),
                          *extra])
        if not torch.cuda.is_available():
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a.png")
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entries.main([name, "--config", config, "--checkpoint", ckpt, "--synthetic",
                              *extra] if name == "evaluate" else
                             [name, "--config", config, "--checkpoint", ckpt, *extra])


@pytest.mark.parametrize("sliding", [False, True], ids=["whole-canvas", "sliding"])
def test_predict_writes_masks_at_each_inputs_size(run, tmp_path, capsys, sliding):
    config, ckpt = run
    sizes = [(30, 22), (40, 40), (50, 70), (33, 47)]      # (h, w); two larger than the canvas
    rng = np.random.default_rng(0)
    src = tmp_path / "in"
    src.mkdir()
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(src / f"im{i}.png")
    out = tmp_path / "out"
    entries.main(["predict", "--config", config, "--checkpoint", ckpt, "--inputs", str(src),
                  "--out_dir", str(out), "--overlay", "--batch_size", "3", "--device", "cpu"]
                 + (["--sliding", "--stride", "8"] if sliding else []))
    text = capsys.readouterr().out
    assert "segmenting 4 image(s) with teacher @ epoch 1" in text
    assert f"({'sliding' if sliding else 'whole-canvas'})" in text
    model, _, _ = evaluate_main.load_eval_model(load_config(config), ckpt, False,
                                                torch.device("cpu"))
    for i, (h, w) in enumerate(sizes):
        pred = np.asarray(Image.open(out / f"im{i}_pred.png"))
        overlay = np.asarray(Image.open(out / f"im{i}_overlay.png"))
        assert pred.shape == (h, w) and overlay.shape == (h, w, 3) and pred.max() < C
        canvas, fill, orig = predict_main._load_canvas(str(src / f"im{i}.png"), CANVAS)
        assert orig == (h, w) and (fill == (h, w)) == (h <= 40 and w <= 40)
        image = to_channel_last(normalize_imagenet(to_channel_first(
            torch.from_numpy(canvas[None]).float() / 255.0)))
        want = predict_main.segment(model, image, C, (32, 32), sliding, 8)[0].numpy()
        want = want[:fill[0], :fill[1]].astype(np.uint8)
        if fill != orig:
            want = np.asarray(Image.fromarray(want, "L").resize((w, h), Image.NEAREST))
        np.testing.assert_array_equal(pred, want)
        base = np.asarray(Image.open(src / f"im{i}.png").convert("RGB"), np.uint8)
        palette = np.asarray(predict_main.colors(C), np.uint8)
        np.testing.assert_array_equal(overlay, (0.5 * base + 0.5 * palette[pred]).astype(np.uint8))
    assert sorted(os.listdir(out)) == sorted(f"im{i}_{k}.png" for i in range(4)
                                             for k in ("pred", "overlay"))

