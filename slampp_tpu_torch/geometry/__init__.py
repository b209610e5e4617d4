"""Manifold math, batched over a leading axis (counterpart of ``slampp_tpu/geometry``)."""
