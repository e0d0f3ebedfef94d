#!/usr/bin/env python3
"""Times the InfoNCE kernel wrappers of one checkout of css_tpu_torch on one
NVIDIA GPU, with chip_smoke.py's inputs and timing, for A/B comparisons.

    python3 kernel_ab.py [--checkout DIR]

DIR is the root of a checkout (the directory that holds css_tpu_torch/; by
default this script's own).  Its kernels are built into DIR/build/ and its
``softsum_kernel`` and ``softsum_moment_kernel`` (compaction included where
the checkout has one) are timed at the main-path shapes under chip_smoke.py's
three weight patterns, with the L2 flushed before each call (20 calls).  One
JSON line per kernel and pattern, labelled with DIR.  Compare two checkouts
only within one run of the card, in turns (A, B, B, A), one process each:

    for d in A B B A; do python3 kernel_ab.py --checkout $d; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, default=HERE)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.checkout.resolve()))
    from css_tpu_torch.ops.kernels import contrastive_kernels as ck

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    label = str(args.checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = smoke._l2_flush(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    for kind in ("dead_half", "thinned", "scattered"):
        a, r, w = smoke._kernel_inputs(torch, ck, g, kind)
        live = int(torch.count_nonzero(w))
        for name, fn in (("k1", ck.softsum_kernel), ("k2", ck.softsum_moment_kernel)):
            ms, device_ms = smoke._timed(torch, lambda: fn(a, r, w, smoke.INV_TEMP),
                                         20, flush)
            print(json.dumps(dict(label=label, kernel=name, w=kind, live_rows=live, ms=ms,
                                  device_ms=device_ms)), flush=True)
        del a, r, w
        torch.cuda.empty_cache()
    print(smoke._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
