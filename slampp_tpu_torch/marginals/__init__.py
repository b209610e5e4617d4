"""Marginal-covariance recovery (counterpart of ``slampp_tpu/marginals``;
reference layer L6: include/slam/Marginals.h).  ``ba_marginals`` is not
ported yet (ROADMAP.md queue 1 item 6)."""

from slampp_tpu_torch.marginals.marginals import MarginalCovariance, dense_marginals
