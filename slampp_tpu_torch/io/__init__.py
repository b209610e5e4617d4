"""Dataset frontend: parser, parse loop, synthetic generators (counterpart of
``slampp_tpu/io``)."""
