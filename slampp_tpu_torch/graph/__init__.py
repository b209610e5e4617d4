"""Typed factor-graph system (counterpart of ``slampp_tpu/graph``)."""
