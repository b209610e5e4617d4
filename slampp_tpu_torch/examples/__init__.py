"""The research and library-usage examples on the port (counterparts of
``examples/``).  Each module's ``main(argv)`` takes ``--device`` (the card
by default, an error without one; ``cpu`` runs on the CPU) and prints what
the JAX package's example prints:

    python -m slampp_tpu_torch.examples.simple_example [--device cpu]
"""

import argparse

import torch


def parse_args(argv, description, add=None, host_only=False):
    """The example's arguments with ``--device``; raises without a card
    unless the CPU is named.  A ``host_only`` example (NumPy alone) takes
    ``--device`` for the common interface and runs without a card."""
    from slampp_tpu_torch.utils.device import require_device

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    if add is not None:
        add(ap)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if not host_only:
        require_device(args.device, ap.prog)
    return args
