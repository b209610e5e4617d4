"""Process and device memory usage (counterpart of
``slampp_tpu/utils/memusage.py``; reference CProcessMemInfo::n_MemoryUsage,
include/slam/MemUsage.h:54,76): the host's resident set from /proc, the
card's allocator statistics from ``torch.cuda.memory_stats``."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _proc_status(key: str) -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def process_memory_usage() -> int:
    """Resident set size in bytes (host)."""
    return _proc_status("VmRSS:")


def peak_memory_usage() -> int:
    """Peak resident set size in bytes (host)."""
    return _proc_status("VmHWM:")


def device_memory_stats(device=None) -> Optional[Dict]:
    """The CUDA caching allocator's statistics of ``device`` (default: the
    current card), with ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_limit`` (the card's total memory) as the JAX package names
    them; None for a CPU device or where no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.get_device_properties(device).total_memory
    return stats


def format_memory_report(device=None) -> str:
    rss = process_memory_usage() / 1048576.0
    peak = peak_memory_usage() / 1048576.0
    out = [f"host RSS: {rss:.1f} MB (peak {peak:.1f} MB)"]
    stats = device_memory_stats(device)
    if stats:
        used = stats["bytes_in_use"] / 1048576.0
        limit = stats["bytes_limit"] / 1048576.0
        out.append(f"device memory: {used:.1f} / {limit:.1f} MB")
    return "; ".join(out)
