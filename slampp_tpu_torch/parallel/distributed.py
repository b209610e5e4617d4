"""Distributed Gauss-Newton over ``torch.distributed`` ranks (counterpart of
``slampp_tpu/parallel/distributed.py``).

The JAX module shards the *edges* over a device mesh with ``shard_map``:

  per-shard local lambda / eta assembly  ->  psum over the mesh  ->
  replicated dense factorization  ->  replicated update

The port runs the same design as one process per rank (SPMD): every rank
holds the whole (small) state vector and a contiguous slice of each edge
type, assembles its partial system, and one ``all_reduce(SUM)`` (``psum``)
makes the full system on every rank, which then solves and updates the
states redundantly.  The backend is NCCL for CUDA tensors and gloo for CPU
ones; a caller may name gloo for CUDA tensors (gloo stages them through the
host), which is how two ranks share one card.

``run_ranks`` starts the ranks: ``world_size`` processes from the
``spawn`` start method, each joining the group through a ``file://`` store
in a temporary directory of its own (so that concurrent launches never
share a port), with a timeout on the group and a deadline on the join.  A
rank that raises or overruns makes ``run_ranks`` kill every rank and raise,
naming the rank.  Each rank's return value comes back through a file.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import EdgeArrays, GraphArrays
from slampp_tpu_torch.linear.dense import solve_dense
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.spans import span


@dataclasses.dataclass
class CollectiveStats:
    """What a mesh's collectives moved: calls, bytes handed to the
    collective per rank, and a timing span per call (CUDA events on the
    card, host seconds on the CPU)."""

    calls: int = 0
    bytes: int = 0
    spans: List = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.calls, self.bytes, self.spans = 0, 0, []

    def ms(self) -> float:
        """Milliseconds spent in the recorded collectives (synchronizes the
        card once)."""
        if self.spans and isinstance(self.spans[0][0], torch.cuda.Event):
            self.spans[-1][1].synchronize()
            return sum(a.elapsed_time(b) for a, b in self.spans)
        return sum(1e3 * (b - a) for a, b in self.spans)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the process group: (group, rank, world size,
    device, axis name), the counterpart of a one-axis ``jax.sharding.Mesh``.
    ``all_reduce`` and ``all_gather`` are the collectives the distributed
    steps use; each records into ``stats``."""

    group: object  # the process group; None is the default group
    rank: int
    world: int
    device: torch.device
    axis: str
    backend: str
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    def _span(self):
        if self.device.type == "cuda":
            return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        return None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sums ``t`` (contiguous) over the ranks, in place (``jax.lax.psum``)."""
        if not t.is_contiguous():
            raise ValueError("Mesh.all_reduce: the collective needs a contiguous tensor")
        with span("dist.allreduce"):
            ev = self._span()
            t0 = ev[0].record() if ev else time.perf_counter()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            if ev:
                ev[1].record()
                self.stats.spans.append(ev)
            else:
                self.stats.spans.append((t0, time.perf_counter()))
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along dim 0 in
        rank order."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        with span("dist.allgather"):
            dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, 0)

    def share(self, n: int):
        """This rank's contiguous share [lo, hi) of n items, ceil(n / world)
        each (the last may be short or empty), and the share size."""
        per = -(-n // self.world)
        lo = min(n, self.rank * per)
        return lo, min(n, lo + per), per


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(device="cuda", backend: str = None, axis: str = "edges") -> Mesh:
    """This rank's :class:`Mesh` from the initialized default process group.

    ``backend`` (default: NCCL for a CUDA device, gloo for the CPU) must be
    the group's: a group never changes backend behind the caller."""
    device = torch.device(device)
    require_device(device, "make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialized; start the ranks with "
                           "run_ranks or torch.distributed.init_process_group")
    want = backend or default_backend(device)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"make_mesh: the process group runs {have!r}, not {want!r}")
    if have == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: NCCL reduces CUDA tensors only")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(None, dist.get_rank(), dist.get_world_size(), device, axis, have)


# ------------------------------------------------------------------ launcher


def _rank_main(fn, rank: int, world: int, backend: str, device: str, init_method: str,
               timeout_s: float, args, out_dir: str) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, write its return
    value (or the traceback) to ``out_dir``."""
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            require_device(dev, "run_ranks")
            idx = dev.index if dev.index is not None else rank % torch.cuda.device_count()
            torch.cuda.set_device(idx)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(out_dir, f"result_{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    except Exception:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
        sys.exit(1)


def run_ranks(fn: Callable, world_size: int, backend: str = None, device="cuda",
              args: Sequence = (), timeout_s: float = 600.0) -> List:
    """Runs ``fn(*args)`` on ``world_size`` ranks, one spawned process each,
    in one process group (``backend``, default :func:`default_backend`) and
    returns their return values in rank order.

    ``fn`` must be importable by the child (a module-level function of this
    package), and its arguments and return value picklable.  A CUDA
    ``device`` without an index gives rank r card r mod the card count.
    Raises RuntimeError naming the rank when a rank fails, TimeoutError
    naming the ranks still running after ``timeout_s``; every rank is
    killed before either is raised."""
    device = torch.device(device)
    require_device(device, "run_ranks")
    backend = backend or default_backend(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("run_ranks: NCCL reduces CUDA tensors only; name gloo for the CPU")
        if (device.index is not None and world_size > 1) or world_size > torch.cuda.device_count():
            raise ValueError(f"run_ranks: NCCL needs one card per rank ({world_size} ranks); "
                             "name gloo to put several ranks on one card")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="slampp_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, str(device), init, timeout_s,
                                   tuple(args), tmp))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while True:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        err = os.path.join(tmp, f"error_{r}.txt")
                        detail = ""
                        if os.path.exists(err):
                            with open(err) as f:
                                detail = f.read()
                        raise RuntimeError(f"run_ranks: rank {r} of {world_size} failed with exit "
                                           f"code {p.exitcode}\n{detail}")
                alive = [r for r, p in enumerate(procs) if p.exitcode is None]
                if not alive:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: rank(s) {alive} of {world_size} did not "
                                       f"finish within {timeout_s} s")
                multiprocessing.connection.wait([procs[r].sentinel for r in alive],
                                                timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------ edge-sharded GN


def shard_graph_edges(graph: GraphArrays, mesh: Mesh) -> GraphArrays:
    """This rank's graph on ``mesh.device``: a contiguous slice of every
    edge type (``ceil(E / world)`` edges, the last rank's short), the
    states, offsets and the gauge factor replicated.  Unlike ``shard_map``'s
    shards, the ranks' slices need not be equal, so no edge is padded."""
    edges = {}
    for name, ea in graph.edges.items():
        lo, hi, _ = mesh.share(ea.valid.shape[0])
        edges[name] = EdgeArrays(*(getattr(ea, f.name)[lo:hi]
                                   for f in dataclasses.fields(EdgeArrays)))
    return dataclasses.replace(graph, edges=edges).to(mesh.device)


def distributed_gn_step(graph: GraphArrays, mesh: Mesh):
    """One distributed GN iteration on this rank's shard (from
    :func:`shard_graph_edges`): local dense assembly, the unary gauge
    factor kept once over the ranks, one all-reduce of (H, g, chi2), the
    replicated dense solve and retraction.  Returns (new_states, dx_norm,
    chi2) with chi2 at the input states, the same on every rank."""
    H, g, chi2 = assembly.assemble_dense(graph)
    n = mesh.world
    if graph.unary_dim > 0:
        # every rank added the unary gauge factor; keep exactly one
        idx = graph.unary_offset + torch.arange(graph.unary_dim, device=H.device)
        H[idx, idx] += -graph.unary_information * (n - 1) / n
    H = mesh.all_reduce(H.contiguous())
    gc = mesh.all_reduce(torch.cat([g, chi2[None]]))
    dx = solve_dense(H, gc[:-1])
    return assembly.apply_update(graph, dx), torch.linalg.vector_norm(dx), gc[-1]

