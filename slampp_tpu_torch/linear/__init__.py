"""Linear solvers (counterpart of ``slampp_tpu/linear``)."""
