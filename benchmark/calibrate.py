"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--variants fp8,half_batch,k2_zero,class_dropped,proto_ema_swapped]

For each seed of a training cell, in one process: the program's readings
exactly as a run takes them (set-up's first three steps), then against the
same float32 reference the readings of each variant.  ``fp8`` is the
control (the reference with float8 convolution operands, in the program's
place) and ``half_batch`` the fault "half of the batch left out" planted in
the reference (it steps on the first half of the labeled and of the
unlabeled batch); any other variant is a fault of ``benchmark/faults.py``
planted in the program, whose set-up's three steps then run with it.  A
state left unchanged reads 1 by ``change_median``'s measure and needs no
run.  One JSON line a seed and variant goes to standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_VARIANTS = ("fp8", "half_batch")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def as_program(ref: dict, weight_decay: float) -> dict:
    """A reference's three steps in the form of the program's readings (the
    momentum after step 1 is the first gradient plus the weight decay)."""
    out = dict(ref)
    out["momentum"] = {k: g + weight_decay * ref["w0"][k] for k, g in ref["grads"].items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--variants",
                        default="fp8,half_batch,k2_zero,class_dropped,proto_ema_swapped")
    args = parser.parse_args(argv)

    import torch

    from benchmark import compare
    from benchmark.faults import FAULTS, planted
    from benchmark.spec import load_cell
    from benchmark.train_cell import TrainRun

    cell = load_cell(args.workload)
    dev = torch.device("cuda:0")
    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in REFERENCE_VARIANTS and v not in FAULTS:
            parser.error(f"unknown variant {v!r}")
    wd = float(cell.config["Optim"]["weight_decay"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = TrainRun(cell, seed, dev)
        run.setup()
        run.free()
        ref = run.reference()
        sides = {"program": run.prog}
        for v in variants:
            if v in REFERENCE_VARIANTS:
                sides[v] = as_program(run.reference(v), wd)
                continue
            faulty = TrainRun(cell, seed, dev)
            with planted(v):
                faulty.setup()
            faulty.free()
            sides[v] = faulty.prog
        for name, side in sides.items():
            row = compare.train_numbers(side, ref, wd)
            for measure, gaps in compare.train_leaves(side, ref, wd).items():
                row[f"{measure}.top"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": name,
                              "losses": side["losses"], **row,
                              "seconds": time.time() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
