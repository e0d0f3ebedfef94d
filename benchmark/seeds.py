"""Generators seeded from a tuple of counters.

``generator(device, seed, stream, *counters)``: the run's ``--seed``, the
stream (0 weights, 1 training draws, 2 eval draws, 3 the sample of eval
batches the reference checks, 4 the loaders' order, 5 the crops that set
the eval teacher's BatchNorm statistics) and the counters within it (step
and rank, or eval pass and batch).  Any whole number works as a seed, however large.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, TRAIN_DRAWS, EVAL_DRAWS, SAMPLE, LOADER, BN_STATS = 0, 1, 2, 3, 4, 5


def seed_of(*key: int) -> int:
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])


def generator(device, *key: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*key))
