"""The SegFormer configuration (``configs/voc_segformer_b5.json``, network
file ``reference/networks/SegFormer.py``): its forward FLOPs at the crop,
its weight rules, and ``correct`` reading false for the faults at the test
size on the CPU; on the card (``-m gpu``), the float8 control and the
contrastive faults failing its cell at the cell's own size.
"""

import json

import pytest
import torch

from conftest import ROOT, tiny, tiny_cell

from benchmark import compare, flops, weights
from benchmark.faults import planted
from benchmark.reference import model as ref_model
from benchmark.run import run_cell

CELL = "voc_segformer_train"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "voc_segformer_b5.json").read_text())
SEED = 2 ** 31 + 101
KERNEL_FAULTS = ["k2_zero", "class_dropped", "proto_ema_swapped"]


def test_forward_flops_at_the_crop():
    """FlopCounterMode over the reference at 512x512, one image: the
    convolutions (patch embeddings, spatial reductions, depthwise, the
    decoder's fuse, the heads), the Linear layers and attention's two
    products (4 N M C a block: 20.2 G), 279.9 G in all; and at 32x32 for
    the test trunk."""
    assert flops.forward_flops(CONFIG, (512, 512)) == 279_903_731_712
    assert abs(279_903_731_712 / 279.9e9 - 1) < 0.01
    assert flops.forward_flops(tiny(CONFIG), (32, 32)) == 11_184_000


@torch.no_grad()
def test_the_weight_rules():
    net = CONFIG["Network"]
    small = tiny(CONFIG)
    model = ref_model.build_reference(small)
    weights.fill_(model, 5, small["Network"])
    kinds = dict(zip((k for k, _ in weights._named(model)),
                     weights._kinds(weights._named(model), small["Network"])))
    assert kinds["backbone.block1.0.attn.q.weight"] == ("trunc_normal", 0.02)
    assert kinds["decode_head.linear_c4.proj.weight"] == ("trunc_normal", 0.02)
    assert kinds["decode_head.linear_pred.weight"] == ("trunc_normal", 0.01)
    assert kinds["backbone.block3.1.mlp.dwconv.dwconv.weight"] == ("he_fan_out", 96)
    assert kinds["backbone.patch_embed1.proj.weight"] == ("he_fan_out",)
    assert kinds["representation.out.bias"] == ("uniform",)
    for name in ("backbone.block1.0.attn.kv.bias", "backbone.patch_embed2.proj.bias",
                 "decode_head.linear_pred.bias", "backbone.norm4.bias",
                 "decode_head.linear_fuse.bn.running_mean"):
        assert kinds[name] == ("zero",), name
    dw = model.backbone.block1[0].mlp.dwconv.dwconv.weight        # fan-out 9, its groups'
    assert float(dw.std()) == pytest.approx((2.0 / 9) ** 0.5, rel=0.1)
    assert float(model.decode_head.linear_pred.weight.std()) == pytest.approx(0.01, rel=0.15)
    full = ref_model.build_reference(CONFIG, device="meta")
    assert net["backbone"] == "mit_b5" and sum(
        p.numel() for p in full.backbone.parameters()) == 81_443_008


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"] + KERNEL_FAULTS)
def test_faults_read_false_at_the_test_size(fault):
    cell = tiny_cell(CELL)
    sound = run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0)
    assert sound["correct"], sound["checks"]
    with planted(fault):
        broken = run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0)
    assert broken["correct"] is False and broken["failed"] >= 1, broken["checks"]


@pytest.mark.gpu
def test_control_and_faults_read_false_at_the_cells_size(card):
    from benchmark.calibrate import as_program
    from benchmark.spec import load_cell
    from benchmark.train_cell import TrainRun

    cell = load_cell(CELL)
    run = TrainRun(cell, SEED, card)
    run.setup()
    run.free()
    ref = run.reference()
    wd = float(cell.config["Optim"]["weight_decay"])
    correct, _, checks = compare.judge(compare.train_numbers(run.prog, ref, wd), cell.limits)
    assert correct, checks
    numbers = compare.train_numbers(as_program(run.reference("fp8"), wd), ref, wd)
    correct, _, checks = compare.judge(numbers, cell.limits)
    assert not correct, checks
    for fault in KERNEL_FAULTS:
        faulty = TrainRun(cell, SEED, card)
        with planted(fault):
            faulty.setup()
        faulty.free()
        correct, _, checks = compare.judge(compare.train_numbers(faulty.prog, ref, wd),
                                           cell.limits)
        assert not correct, (fault, checks)
