"""Host planners and device assembly (counterpart of ``slampp_tpu/core``)."""
