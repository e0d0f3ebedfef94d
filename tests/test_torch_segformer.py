"""SegFormer in the port (``css_tpu_torch/models/segformer.py``) against its
plain float32 reference (``benchmark/reference/networks/SegFormer.py``), on
the CPU at the test trunk ``mit_tiny``.

Both sides are filled with the benchmark's weight maker from one seed, in
f32, and then every Linear weight is multiplied by ``LINEAR_SCALE`` on both
sides: at the rule's std of 0.02 the pre-activations are so small that GELU
and the softmax are nearly linear (exact GELU and its tanh form agree there
to 1e-7), and scaled they are of order one.  Tolerances: the outputs and the
BatchNorm statistics agree to 8.2e-7 of their largest value (the same f32
operations in another grouping), so 1e-5; a parameter's gradient is a sum
over every position of the batch in another order and agrees to 1.4e-5 of
the larger of its norm and the median leaf's (the floor for leaves whose
gradient vanishes in exact arithmetic, such as the decoder's Linear biases
ahead of the fuse's BatchNorm), so 1e-4.

At 32x32 every stage attends to one key (the reductions R 8/4/2/1 shrink
each map to 1x1), where the softmax is constant and the queries get no
gradient; 64x64 gives four keys a stage, so both sizes are compared.
"""

import statistics

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference.model import build_reference
from css_tpu_torch.cli import entries, train_main
from css_tpu_torch.models.deeplabv3 import build_model
from css_tpu_torch.models.segformer import SegFormerDual
from css_tpu_torch.train.draws import sample_step_draws
from css_tpu_torch.train.state import create_train_state
from css_tpu_torch.train.train_step import StepConfig, make_train_step
from css_tpu_torch.utils.profiling import reset, snapshot, tracing
from tests.test_torch_driver import _probe_run, _tiny_yaml

C, D = 6, 16
NET = {"name": "SegFormer", "num_class": C, "backbone": "mit_tiny", "output_dim": D}
SEED = 2 ** 31 + 29
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
LINEAR_SCALE = 25.0


def _pair(seed=SEED):
    ref = build_reference({"Network": NET})
    weights.fill_(ref, seed, NET)
    prog = build_model(C, D, "mit_tiny")
    weights.fill_(prog, seed, NET)
    with torch.no_grad():                   # pre-activations of order one (see above)
        for m in (prog, ref):
            for p in m.parameters():
                if p.dim() == 2:
                    p.mul_(LINEAR_SCALE)
    return prog, ref


def _images(hw, n=4, seed=0):
    return torch.randn(n, hw, hw, 3, generator=torch.Generator().manual_seed(seed))


def _close(a, b, tol=OUT_TOL):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_tensors_are_the_references_names_and_shapes():
    assert weights.layout(build_model(C, D, "mit_tiny")) == weights.layout(
        build_reference({"Network": NET}, device="meta"))
    big = dict(NET, num_class=21, output_dim=256, backbone="mit_b5")
    prog = build_model(21, 256, "mit_b5", dtype=torch.bfloat16)
    assert weights.layout(prog) == weights.layout(build_reference({"Network": big},
                                                                  device="meta"))
    # MiT-B5 as published: 81.4 M parameters in the encoder, 86.4 M in all
    assert sum(p.numel() for p in prog.backbone.parameters()) == 81_443_008
    assert sum(p.numel() for p in prog.parameters()) == 86_445_269


def test_layer_norms_have_the_references_eps():
    prog, ref = _pair()
    ours = {k: m.eps for k, m in prog.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    theirs = {k: m.eps for k, m in ref.named_modules() if hasattr(m, "eps")}
    assert ours == theirs and set(ours.values()) == {1e-5, 1e-6}


@pytest.mark.parametrize("hw", [32, 64])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_outputs_match_the_reference(hw, groups, mode):
    prog, ref = _pair()
    getattr(prog, mode)()
    getattr(ref, mode)()
    x = _images(hw)
    with torch.no_grad():
        pp, rp = prog(x, bn_groups=groups)
        pr, rr = ref(x, bn_groups=groups)
    assert pp.dtype == rp.dtype == torch.float32
    assert tuple(pp.shape) == (4, *prog.output_hw((hw, hw)), C)
    assert tuple(rp.shape) == (4, *prog.output_hw((hw, hw)), D)
    assert _close(pp, pr) and _close(rp, rr)


@pytest.mark.parametrize("hw", [32, 64])
@pytest.mark.parametrize("groups", [1, 2])
def test_gradients_and_bn_statistics_match_the_reference(hw, groups):
    prog, ref = _pair()
    x = _images(hw, seed=1)
    grads, stats = [], []
    for m in (prog, ref):
        m.train()
        pred, rep = m(x, bn_groups=groups)
        (pred.square().mean() + (rep * torch.linspace(-1, 1, D)).sum()).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
        stats.append(dict(m.named_buffers()))
    gp, gr = grads
    assert all(g is not None for g in gp.values())
    med = statistics.median(float(g.norm()) for g in gr.values())
    worst = max((float((gp[k] - gr[k]).norm()) / max(float(gr[k].norm()), med), k) for k in gr)
    assert worst[0] <= GRAD_TOL, worst
    assert all(_close(stats[0][k], stats[1][k]) for k in stats[1])
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in stats[0].items()
               if k.endswith("running_mean"))


@pytest.mark.parametrize("key,kw", [("output_stride", {"output_stride": 16}),
                                    ("remat", {"remat": True}), ("remat", {"remat": (2,)})])
def test_a_mit_trunk_refuses_resnet_settings(key, kw):
    with pytest.raises(ValueError, match=key):
        build_model(C, D, "mit_tiny", **kw)


def _tiny_step(crop=64, b=2):
    """One ``ori`` step of ``mit_tiny`` through ``make_train_step``."""
    cfg = StepConfig(num_classes=C, crop_hw=(crop, crop), scale_range=(0.5, 1.5),
                     num_queries=8, num_negatives=16)
    state = create_train_state(build_model(C, D, "mit_tiny"), C, D, base_lr=1e-2,
                               weight_decay=5e-4, total_steps=100, device="cpu")
    h, w = state.model.output_hw(cfg.crop_hw)
    rng = np.random.default_rng(3)
    canvas = (crop + 8, crop + 8)
    batch = {"l_image": torch.from_numpy(rng.integers(0, 256, (b, *canvas, 3), np.uint8)),
             "l_label": torch.from_numpy(rng.integers(0, C, (b, *canvas), np.int32)),
             "l_valid_hw": torch.tensor([canvas] * b, dtype=torch.int32),
             "u_image": torch.from_numpy(rng.integers(0, 256, (b, *canvas, 3), np.uint8)),
             "u_valid_hw": torch.tensor([canvas] * b, dtype=torch.int32)}
    draws = sample_step_draws(torch.Generator().manual_seed(4), cfg, b, b, 2 * b * h * w)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    state, metrics = make_train_step(cfg)(state, batch, draws, 1.0)
    return state, metrics, before


def test_an_ori_step_changes_every_student_parameter():
    state, metrics, before = _tiny_step()
    assert isinstance(state.model, SegFormerDual) and state.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    still = [k for k, p in state.model.named_parameters() if torch.equal(p, before[k])]
    assert not still, still


def test_encoder_and_decoder_spans_nest_in_the_forwards():
    reset()
    _tiny_step(crop=32)
    assert "css.encoder" not in snapshot()              # off: nothing recorded
    with tracing():
        _tiny_step(crop=32)
    spans = snapshot()
    reset()
    for name in ("css.encoder", "css.decoder"):         # the teacher's and two students'
        assert spans[name]["count"] == 3 and spans[name]["parent"] == "css.teacher"
    assert spans["css.step"]["count"] == 1


def test_the_training_entry_point_trains_a_mit_trunk(tmp_path, monkeypatch):
    config = _tiny_yaml(tmp_path, **{"Network.name": "SegFormer",
                                     "Network.backbone": "mit_tiny"})
    seen = _probe_run(monkeypatch)
    entries.main(["ori", "--config", config, "--synthetic", "--device", "cpu",
                           "--num_labels", "4", "--job_name", "mit", "--total_iter", "2"])
    assert isinstance(seen["state"].model, SegFormerDual)
    assert len(seen["metrics"]) == 2
    assert all(np.isfinite(list(m.values())).all() for m in seen["metrics"])
    job = tmp_path / "ckpt" / "mit"
    assert "* mIoU" in (job / "train.log").read_text()
    assert (job / "last_model").exists()


def test_the_resnet_checkpoint_is_not_loaded_into_a_mit_trunk(tmp_path):
    """``Network.pretrained`` names a ResNet-101 state dict (here a file that
    ``torch.load`` would refuse): a MiT trunk never reads it, and its remat
    default stays off at a crop over 512², where a ResNet's is on."""
    path = tmp_path / "resnet101.pth"
    path.write_bytes(b"")
    config = _tiny_yaml(tmp_path, **{"Network.name": "SegFormer",
                                     "Network.backbone": "mit_tiny",
                                     "Network.pretrained": str(path)})
    cfg = train_main.load_config(config)
    cfg.set("Dataset.crop_size", (600, 600))
    args = entries.ori_pseudo_parser().parse_args(["--config", config, "--device", "cpu"])
    state = train_main._build_state_and_steps(cfg, args, torch.device("cpu"))[0]
    assert isinstance(state.model, SegFormerDual)
