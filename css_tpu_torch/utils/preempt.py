"""Cooperative SIGTERM handling: checkpoint and exit on preemption, one
process; counterpart of ``css_tpu/utils/preempt.py``.

The handler only sets a flag; the training loop polls it after each step,
writes the rolling checkpoint and returns, so ``--resume`` continues from
the preemption point.
"""

from __future__ import annotations

import signal

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    def __init__(self):
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

    def should_stop(self) -> bool:
        """True once SIGTERM has arrived."""
        return self._flagged
