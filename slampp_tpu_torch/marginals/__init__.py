"""Marginal-covariance recovery (counterpart of ``slampp_tpu/marginals``;
reference layer L6: include/slam/Marginals.h); ``ba_marginals`` recovers
them through the Schur complement of a BA system."""

from slampp_tpu_torch.marginals.marginals import MarginalCovariance, dense_marginals
from slampp_tpu_torch.marginals.ba_marginals import schur_marginals
