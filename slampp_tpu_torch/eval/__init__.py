"""Evaluation and analysis tools (counterpart of ``slampp_tpu/eval``;
reference layer L11: Eigenvalues.h).  ``error_eval`` is not ported yet
(ROADMAP.md queue 1 item 11)."""
