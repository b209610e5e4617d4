"""Graph/trajectory plotting and sparsity rasterization (counterpart of
``slampp_tpu/viz/plot.py``).  matplotlib is imported when a plot is made,
not with the module: a machine without it can run everything else, and a
plot there raises an ImportError that names matplotlib.

Reference analogs: ``CFlatSystem::Plot2D/Plot3D`` (FlatSystem.h:2717,2742,
TGA output via the Bitmap.h AA rasterizer) and
``CUberBlockMatrix::Rasterize`` (BlockMatrix.h:292).  Non-goal per
SURVEY.md §7: the TGA rasterizer itself — standard matplotlib output files
replace it.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError naming
    matplotlib and what needs it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plotting (-p, the -dsm raster) needs matplotlib, which is not "
                          "installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_system(system, path: str, edge_types=None) -> None:
    """Plot vertex positions + edges to an image file (png/pdf by suffix)."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(8, 8))
    # gather 2D or 3D positions per vertex type
    pts = {}
    for vid, (t, i) in system.vertex_index.items():
        st = system.vertex_state(vid)
        pts[vid] = st[:2] if len(st) >= 2 else None
    for tname in system.edge_type_names:
        if edge_types and tname not in edge_types:
            continue
        for vids in system._edges[tname]["vids"]:
            if len(vids) >= 2 and pts.get(vids[0]) is not None and pts.get(vids[1]) is not None:
                a, b = pts[vids[0]], pts[vids[1]]
                ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="0.6", lw=0.3)
    xy = np.array([p for p in pts.values() if p is not None])
    if len(xy):
        ax.plot(xy[:, 0], xy[:, 1], ".", ms=1.0, color="tab:blue")
    ax.set_aspect("equal")
    ax.set_title(f"{system.n_vertices} vertices / {system.n_edges} edges")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_system_3d(system, path: str) -> None:
    """3D trajectory/graph plot (Plot3D analog, FlatSystem.h:2742)."""
    plt = _pyplot()

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    pts = {}
    for vid in system.vertex_index:
        st = system.vertex_state(vid)
        if len(st) >= 3:
            pts[vid] = st[:3]
    for tname in system.edge_type_names:
        for vids in system._edges[tname]["vids"]:
            if len(vids) >= 2 and vids[0] in pts and vids[1] in pts:
                a, b = pts[vids[0]], pts[vids[1]]
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "-", color="0.7", lw=0.3)
    if pts:
        xyz = np.stack(list(pts.values()))
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1.0, c="tab:blue")
    ax.set_title(f"{system.n_vertices} vertices / {system.n_edges} edges")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def rasterize_block_matrix(H: np.ndarray, path: str, threshold: float = 0.0) -> None:
    """Sparsity plot of a (dense-assembled) system matrix
    (CUberBlockMatrix::Rasterize analog)."""
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.spy(np.abs(np.asarray(H)) > threshold, markersize=0.5)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
