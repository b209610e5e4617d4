"""Plotting: trajectory / graph plots and matrix sparsity rasters
(counterpart of ``slampp_tpu/viz``; replaces the reference's TGA rasterizer,
FlatSystem.h:2717 Plot2D / Plot3D and CUberBlockMatrix::Rasterize, with
matplotlib, imported only when a plot is made)."""

from slampp_tpu_torch.viz.plot import plot_system, plot_system_3d, rasterize_block_matrix

__all__ = ["plot_system", "plot_system_3d", "rasterize_block_matrix"]
