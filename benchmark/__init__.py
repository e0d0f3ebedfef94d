"""The benchmark of ``css_tpu_torch`` on NVIDIA H100 cards (see README.md).

Nothing under this package imports JAX or ``css_tpu``; ``reference/``
imports nothing of the program under test either.
"""
