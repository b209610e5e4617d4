"""slampp_tpu_torch — the PyTorch / CUDA port of slampp_tpu.

The JAX package ``slampp_tpu`` stays the reference; this package mirrors its
subpackage and module names (each module names its JAX counterpart) and
imports ``torch``, never ``jax``.  Its first slice is the partitioned
("v3") Gauss-Newton path on SE(2) pose graphs: generate / parse / build the
graph on the host, assemble the block Hessian, eliminate the part interiors
and the dense separator on the device, and update the states.

Policy: states, right-hand sides and chi2 are ``torch.float64``, always
named explicitly (the global default dtype is never read); every function
that makes a tensor takes a ``device``.  Float32 matrix products stay full
float32 (TF32 off), as the JAX einsums ran at ``precision=HIGHEST``.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from slampp_tpu_torch import models  # noqa: E402,F401  (registers the model types)

__version__ = "0.1.0"
