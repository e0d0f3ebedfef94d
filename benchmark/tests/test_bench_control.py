"""``correct`` has to come out false for the control and for the faults a
cell can have.

On the CPU, at the test size, a run of the harness (without its look for a
card) with the timed path broken underneath (``benchmark/faults.py``): a
training step that returns its state unchanged; a step that sees half of
the batch (the first half of the labeled and of the unlabeled images, with
their draws) and takes its means over that half; and faults of the
contrastive path: K2's anchor gradient zero, one class's live rows dropped
by the compaction, the prototypes' moving average swapped.  The one-card
cells have no exchange between cards to leave out, and a training step
produces no answer to alter.

On the card (``-m gpu``), at each cell's own size, one seed: the control
(the reference with float8 convolution operands, in the program's place)
and the program with each contrastive fault planted, against the
reference, under the cell's limits.
"""

import pytest
import torch

from conftest import tiny_cell

from benchmark import compare
from benchmark.faults import planted
from benchmark.run import run_cell

SEED = 2 ** 31 + 101
KERNEL_FAULTS = ["k2_zero", "class_dropped", "proto_ema_swapped"]


def _run(cell):
    return run_cell(cell, SEED, 0.3, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"] + KERNEL_FAULTS)
def test_train_faults_read_false(fault):
    cell = tiny_cell("voc_ori_train")
    sound = _run(cell)
    assert sound["correct"], sound["checks"]
    with planted(fault):
        broken = _run(cell)
    assert broken["correct"] is False and broken["failed"] >= 1, broken["checks"]
    if fault == "unchanged_state":
        assert broken["checks"]["change_median"]["value"] == pytest.approx(1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["voc_ori_train", "city_ori_train"])
def test_control_reads_false_at_the_cells_size(name, card):
    from benchmark.calibrate import as_program
    from benchmark.spec import load_cell
    from benchmark.train_cell import TrainRun

    cell = load_cell(name)
    run = TrainRun(cell, SEED, card)
    run.setup()
    run.free()
    ref = run.reference()
    wd = float(cell.config["Optim"]["weight_decay"])
    numbers = compare.train_numbers(as_program(run.reference("fp8"), wd), ref, wd)
    correct, failed, checks = compare.judge(numbers, cell.limits)
    assert not correct, checks
    for fault in KERNEL_FAULTS:
        faulty = TrainRun(cell, SEED, card)
        with planted(fault):
            faulty.setup()
        faulty.free()
        correct, failed, checks = compare.judge(compare.train_numbers(faulty.prog, ref, wd),
                                                cell.limits)
        assert not correct, (fault, checks)
