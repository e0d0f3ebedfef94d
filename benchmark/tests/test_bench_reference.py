"""CPU tests of the plain reference against the program at a tiny size:
the network, the augmentation, the losses and the weight maker.  The
reference itself imports nothing of the program; these tests import both.
"""

import pytest
import torch
import torch.nn.functional as F

from conftest import tiny_cell

from benchmark import weights
from benchmark.reference import augment as A
from benchmark.reference import draws as RD
from benchmark.reference.model import build_reference
from benchmark.reference.step import StepSettings, contrastive, cross_entropy, ohem


def _program_model(cfg):
    from css_tpu_torch.models.deeplabv3 import build_model

    net = cfg["Network"]
    return build_model(net["num_class"], net["output_dim"], net["backbone"], dtype=torch.float32)


@pytest.mark.parametrize("groups", [1, 2])
def test_network_matches_the_program(groups):
    cfg = tiny_cell("voc_ori_train").config
    prog, ref = _program_model(cfg), build_reference(cfg)
    assert weights.layout(prog) == weights.layout(ref)
    weights.fill_(prog, 3, cfg["Network"])
    weights.fill_(ref, 3, cfg["Network"])
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    # the ASPP's pooled branch normalises 8 / groups values a channel, and the
    # program forms their variance as E[x^2] - E[x]^2 in float32
    tol = 1e-4 if groups == 1 else 1e-3
    for mode in ("train", "eval"):
        prog.train(mode == "train")
        ref.train(mode == "train")
        with torch.no_grad():
            (p1, r1), (p2, r2) = prog(x, bn_groups=groups), ref(x, bn_groups=groups)
        assert torch.allclose(p1, p2, rtol=tol, atol=tol * float(p2.abs().max()))
        assert torch.allclose(r1, r2, rtol=tol, atol=tol * float(r2.abs().max()))
    for (k, a), (_, b) in zip(sorted(prog.named_buffers()), sorted(ref.named_buffers())):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), k


def test_weights_are_the_seeds_and_fill_every_tensor():
    cfg = tiny_cell("voc_ori_train").config
    a, b = build_reference(cfg), build_reference(cfg)
    weights.fill_(a, 9, cfg["Network"])
    weights.fill_(b, 9, cfg["Network"])
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y) and torch.isfinite(x).all(), k
    weights.fill_(b, 10, cfg["Network"])
    assert not torch.equal(a.backbone.stem.conv.weight, b.backbone.stem.conv.weight)
    w = a.backbone.stem.conv.weight
    assert float(w.std()) == pytest.approx((2.0 / (64 * 49)) ** 0.5, rel=0.1)


@pytest.mark.parametrize("photometric", [False, True])
def test_augmentation_matches_the_program(photometric):
    """The program resamples with bf16 operands on purpose; labels and
    confidences are picked exactly."""
    from css_tpu_torch.ops.augment import batch_transform
    from css_tpu_torch.train.draws import sample_augment_draws

    g = torch.Generator().manual_seed(1)
    img = torch.rand(3, 3, 40, 48, generator=g)
    lab = torch.randint(-1, 6, (3, 1, 40, 48), generator=g)
    conf = torch.rand(3, 1, 40, 48, generator=g)
    vhw = torch.tensor([[30, 40], [40, 48], [22, 17]])
    d = sample_augment_draws(torch.Generator().manual_seed(5), 3, (0.5, 1.5), photometric)
    rd = RD.augment(torch.Generator().manual_seed(5), 3, (0.5, 1.5), photometric)
    a = batch_transform(img, lab, conf, vhw, (32, 32), **d.as_kwargs())
    b = A.transform(img, lab, conf, vhw, (32, 32), rd)
    assert float((a[0] - b[0]).abs().max()) < 0.02
    assert torch.equal(a[1].long(), b[1].long()) and torch.equal(a[2], b[2])


def test_cutmix_matches_the_program():
    from css_tpu_torch.ops.mixing import mix_batch
    from css_tpu_torch.train.draws import sample_mix_draws

    g = torch.Generator().manual_seed(2)
    img, conf = torch.rand(4, 3, 32, 32, generator=g), torch.rand(4, 1, 32, 32, generator=g)
    lab = torch.randint(-1, 6, (4, 1, 32, 32), generator=g)
    d = sample_mix_draws(torch.Generator().manual_seed(4), "cutmix", 4, 32, 6)
    a = mix_batch(img, lab, conf, mode="cutmix", **d.as_kwargs())
    b = A.cutmix(img, lab, conf, d.cut_w, d.u_x, d.u_y)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_step_draws_are_the_programs():
    from css_tpu_torch.train.draws import sample_step_draws
    from css_tpu_torch.train.train_step import StepConfig

    cfg = StepConfig(num_classes=6, crop_hw=(32, 32), scale_range=(0.5, 1.5), num_queries=8,
                     num_negatives=16)
    d = sample_step_draws(torch.Generator().manual_seed(7), cfg, 2, 2, 256)
    r = RD.step(torch.Generator().manual_seed(7), 6, (32, 32), (0.5, 1.5), 2, 2, 256, 8)
    for part in ("l_aug", "u_crop", "t_crop", "u_aug", "mix", "contrast"):
        for k, v in r[part].items():
            assert torch.equal(getattr(getattr(d, part), k), v), (part, k)


def test_losses_match_the_program():
    from css_tpu_torch.losses.contrastive import prototype_contrastive_loss
    from css_tpu_torch.losses.cross_entropy import cross_entropy as p_ce
    from css_tpu_torch.losses.cross_entropy import ohem_cross_entropy

    s = StepSettings(tiny_cell("voc_ori_train").config, 100)
    g = torch.Generator().manual_seed(0)
    b, h, w, d, c = 4, 8, 8, 16, 6
    n = b * h * w
    rep = torch.randn(b, h, w, d, generator=g, requires_grad=True)
    oh = F.one_hot(torch.randint(0, c, (b, h, w), generator=g), c).float()
    mask = (torch.rand(b, h, w, generator=g) < 0.8).float()
    prob = torch.softmax(torch.randn(b, h, w, c, generator=g), -1)
    protos = torch.randn(c, d, generator=g) * (torch.arange(c) % 2)[:, None]
    tie = torch.randint(0, 1 << 24, (n,), generator=g, dtype=torch.int32)
    u1, u = torch.rand(c, s.num_queries, generator=g), torch.rand(c, n, generator=g)
    l1, p1 = prototype_contrastive_loss(rep, oh, mask, prob, protos, tie, u1, u,
                                        num_negatives=s.num_negatives, temp=s.temp,
                                        strong_threshold=s.strong_threshold, alpha=s.proto_alpha)
    g1, = torch.autograd.grad(l1, rep)
    l2, p2 = contrastive(rep, oh, mask, prob, protos, tie, u1, u, s)
    g2, = torch.autograd.grad(l2, rep)
    assert float(l1) == pytest.approx(float(l2), rel=1e-3)
    assert torch.allclose(p1, p2, atol=1e-6)
    assert float((g1 - g2).norm()) < 1e-2 * float(g2.norm())

    logits = torch.randn(2, 16, 16, c, generator=g)
    labels = torch.randint(-1, c, (2, 16, 16), generator=g)
    assert float(p_ce(logits, labels)) == pytest.approx(float(cross_entropy(logits, labels)),
                                                        rel=1e-6)
    assert float(ohem_cross_entropy(logits, labels, 0.7, 300)) == pytest.approx(
        float(ohem(logits, labels, 0.7, 300)), rel=1e-6)


def test_float8_control_rounds_coarser_than_bfloat16():
    from benchmark.train_cell import fp8_round

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0), requires_grad=True)
    q = fp8_round(x)
    rel = float(((q - x).norm() / x.norm()))
    bf = float(((x.to(torch.bfloat16).float() - x).norm() / x.norm()))
    assert rel > 8 * bf
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_leaf_gap_measure():
    from benchmark.compare import leaf_gaps

    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-6)}
    same = {k: v.clone() for k, v in ref.items()}
    assert max(leaf_gaps(same, ref).values()) == 0.0
    unchanged = leaf_gaps({k: torch.zeros_like(v) for k, v in ref.items()}, ref)
    assert unchanged["a"] == unchanged["b"] == pytest.approx(1.0)
    # a tiny leaf is measured against the median leaf's norm
    off = leaf_gaps(dict(same, c=torch.full((4,), 2e-6)), ref)
    assert off["c"] == pytest.approx(2e-6 / 2.0, rel=1e-3)
