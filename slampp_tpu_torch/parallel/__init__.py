"""Multi-rank distribution (counterpart of ``slampp_tpu/parallel``): the
edge-sharded GN step, landmark-sharded bundle adjustment and its marginals,
and rank-parallel chunk elimination over ``torch.distributed`` ranks, one
process per rank (``run_ranks``), with all-reduce in place of ``psum``."""

from slampp_tpu_torch.parallel.distributed import (
    Mesh,
    distributed_gn_step,
    make_mesh,
    run_ranks,
    shard_graph_edges,
)
