"""Problem-type models (counterpart of ``slampp_tpu/models``).  Importing a
model module registers its vertex and edge types."""

from slampp_tpu_torch.models import ba, rocv, se2, se3, sim3  # noqa: F401
