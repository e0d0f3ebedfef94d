"""Cooperative SIGTERM handling: checkpoint and exit on preemption;
counterpart of ``css_tpu/utils/preempt.py``.

The handler only sets a flag; the training loop polls it after each step,
writes the rolling checkpoint and returns, so ``--resume`` continues from
the preemption point.  Over more than one rank, a rank that left alone
would leave the others waiting in a collective, so the poll takes the
flag's maximum over the ranks every ``check_every`` steps (a host
synchronisation, kept off the other steps) and all ranks leave together.
"""

from __future__ import annotations

import signal

import torch

from css_tpu_torch import parallel

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """``device``: where the ranks' reduction of the flag runs (the rank's
    own device: NCCL reduces only CUDA tensors)."""

    def __init__(self, check_every: int = 10, device="cpu"):
        self.check_every = max(int(check_every), 1)
        self.device = torch.device(device)
        self._flagged = False
        self._installed = False
        self._prev = None

    def install(self) -> "PreemptionGuard":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_term)
            self._installed = True
        except ValueError:
            # signal.signal works on the main thread only; a caller that
            # drives training from another thread runs unguarded
            pass
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False

    def _on_term(self, signum, frame):  # noqa: ARG002 (signal signature)
        self._flagged = True

    def should_stop(self, step_in_epoch: int = 0) -> bool:
        """True once the run should checkpoint and exit.  One rank: the
        local flag, every step.  More: true on every rank at the first check
        (``step_in_epoch`` a multiple of ``check_every``) after SIGTERM
        reached any rank; every rank calls it at the same steps."""
        if parallel.world_size() == 1:
            return self._flagged
        if step_in_epoch % self.check_every:
            return False
        return parallel.any_process(self._flagged, self.device)
