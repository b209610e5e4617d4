"""Where the port's entry points run: on the card unless the caller names
the CPU, and never on the CPU in place of a missing card."""

from __future__ import annotations

import torch


def require_device(device: torch.device, who: str) -> None:
    """Raises RuntimeError for a CUDA device when no card is available."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
