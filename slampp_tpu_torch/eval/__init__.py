"""Evaluation and analysis tools (counterpart of ``slampp_tpu/eval``;
reference layer L11: ErrorEval.h, Eigenvalues.h)."""

from slampp_tpu_torch.eval.error_eval import align_umeyama, ate_rmse, rpe_aa_rmse, rpe_rmse

__all__ = ["align_umeyama", "ate_rmse", "rpe_aa_rmse", "rpe_rmse"]
