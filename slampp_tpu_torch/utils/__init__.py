"""Utilities (counterpart of ``slampp_tpu/utils``)."""
