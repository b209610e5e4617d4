"""The multi-rank paths of slampp_tpu_torch (``parallel/distributed.py``,
``parallel/distributed_incremental.py``, ``graft_entry.py``) on gloo ranks
on the CPU against the JAX package's ``shard_map`` versions on the virtual
CPU mesh: the edge-sharded GN step at 1, 2 and 4 ranks against JAX's at 2
devices (states 1e-9, |dx| 1e-8, chi2 1e-10 relative), chunk elimination
and packing at 2 ranks (1e-12), the multi-rank dry run, and the launcher's
failure paths (a failing or hanging rank makes ``run_ranks`` raise within
its deadline, naming the rank; no card, no CUDA mesh).

The ranks are spawned processes: they import only the port."""

import operator
import time

import numpy as np
import pytest
import torch

from slampp_tpu.parallel import distributed_gn_step as jax_gn_step
from slampp_tpu.parallel import make_mesh as jax_make_mesh
from slampp_tpu.parallel import shard_graph_edges as jax_shard_graph_edges
from slampp_tpu.parallel import distributed_incremental as jdi
from slampp_tpu_torch import graft_entry
from slampp_tpu_torch.apps import distributed as apps_dist
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.parallel import distributed_incremental as pdi
from slampp_tpu_torch.parallel.distributed import make_mesh, run_ranks

from tests._torch_jax_util import jax_text_system

GN_TEXT = make_manhattan(n_poses=100, loop_prob=0.5, loop_separation=10, loop_radius=4.0,
                         seed=1)[0]


@pytest.fixture(scope="module")
def jax_gn():
    """One JAX distributed_gn_step on a 2-device CPU mesh."""
    system = jax_text_system(GN_TEXT)
    mesh = jax_make_mesh(2)
    states, norm, chi2 = jax_gn_step(jax_shard_graph_edges(system.snapshot(), mesh), mesh)
    return {k: np.asarray(v) for k, v in states.items()}, float(norm), float(chi2)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_distributed_gn_step_matches_jax(jax_gn, world):
    states, norm, chi2 = jax_gn
    res = apps_dist.run_dist_gn(100, world, "gloo", "cpu", n_steps=1, text=GN_TEXT,
                                timeout_s=300)
    assert res["world"] == world and res["rank_devices"] == ["cpu"] * world
    assert abs(res["chi2"][0] - chi2) <= 1e-10 * chi2
    assert abs(res["dx_norm"][0] - norm) <= 1e-8 * norm
    for t, ref in states.items():
        np.testing.assert_allclose(res["states"][t], ref, rtol=0, atol=1e-9)
    assert res["allreduce_calls"] == 2
    assert res["allreduce_bytes_per_step"] == 8 * (res["state_dim"] ** 2 + res["state_dim"] + 1)


def _chunk_inputs():
    """test_distributed.py's mesh chunk-elimination inputs."""
    rng = np.random.default_rng(7)
    chunks = []
    for _ in range(11):
        nint = int(rng.integers(6, 19)) * 3
        nb = int(rng.integers(2, 5)) * 3
        d = nint + nb
        A = rng.normal(size=(d, d))
        chunks.append((A @ A.T + d * np.eye(d), rng.normal(size=d), nint))
    return chunks


def test_chunk_elimination_matches_jax():
    chunks = _chunk_inputs()
    packed = pdi.pack_chunks(chunks)
    for got, want in zip(packed, jdi.pack_chunks(chunks)):
        np.testing.assert_array_equal(got, want)
    Hs, gs, nis, _ = packed
    want = jdi.eliminate_chunks_mesh(Hs, gs, nis, jax_make_mesh(2, axis="chunks"))
    res = run_ranks(apps_dist._chunks_rank, 2, "gloo", "cpu", (Hs, gs, nis, "gloo", "cpu"),
                    timeout_s=300)
    for got, ref in zip(res[0]["out"], want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12)


def test_dryrun_multichip_on_gloo():
    res = graft_entry.dryrun_multichip(2, "gloo", "cpu", timeout_s=300)
    assert len(res) == 2 and all(r["marginals_finite"] for r in res)
    # the replicated results agree over the ranks
    for k in ("gn_dx_norm", "ba_dx_norm", "big_ba_dx_norm"):
        assert res[0][k] == res[1][k] and np.isfinite(res[0][k])


@pytest.mark.parametrize("case", ["raises", "hangs"])
def test_run_ranks_fails_within_its_deadline(case):
    """A rank that raises, or one that overruns, makes run_ranks kill the
    ranks and raise naming the rank, well before a hang would cost the
    suite its time limit."""
    t0 = time.monotonic()
    if case == "raises":
        with pytest.raises(RuntimeError, match=r"rank \d of 2 failed(.|\n)*ZeroDivisionError"):
            run_ranks(operator.truediv, 2, "gloo", "cpu", (1, 0), timeout_s=60)
    else:
        with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\] of 2"):
            run_ranks(time.sleep, 2, "gloo", "cpu", (120,), timeout_s=8)
    assert time.monotonic() - t0 < 50


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("call", ["make_mesh", "run_ranks"])
def test_cuda_mesh_without_a_card_raises(call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "make_mesh":
            make_mesh(device="cuda")
        else:
            run_ranks(operator.add, 1, None, "cuda", (1, 2), timeout_s=30)
