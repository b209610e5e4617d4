"""slampp_tpu_torch/ops/schur_kernels.py, the sparse Schur engine's
fine-slot sums, and the slot-major table ``SparseSchurSolver.symbolic``
builds for them: on the CPU, that the table holds each hit slot's terms in
the routing order and that the table with the plain version reproduces the
routing tables' formula (every contribution, the pair corrections of all
ordered pairs among them, concatenated and summed in the grouped segments
of ``src_perm`` / ``src_starts`` / ``src_ends``); the damped step against
the engine on that formula; the kernel's own source
(``csrc/schur_kernels.cu``) built for the host over ``tests/_cuda_host.h``
and run on the CPU at every (pose, landmark) dim pair it is built for and
in the engine; and (marked ``gpu``) the CUDA kernel on the card.

Graphs: a Sim(3) scene (``camsim3`` + ``xyz``, blocks (7, 3)); an SE(3)
graph with ``landmark3d`` landmarks, pose-pose edges (some of whose H_ij
land transposed) and unary pose priors (6, 3); an SE(2) landmark graph
(3, 2).  Sums are compared within (n_s + dl) 2^-52 S per entry, n_s the
slot's term count, dl the landmark dim and S the sum of its terms'
absolute values (a pair's as sum_k |BD_ak| |B_bk|): each of two sums
taken in any order is within (n_s - 1 + dl) 2^-53 S of the exact one (the
n_s - 1 additions, and each pair's dl-term dot product, which the two
versions also round in their own order).

The ``gpu`` cases need no JAX: ``python -m pytest
tests/test_torch_schur_kernels.py -m gpu --noconftest``.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from slampp_tpu_torch.apps.sim3 import venice_ba_system
from slampp_tpu_torch.graph.types import TYPE_REGISTRY, EdgeType
from slampp_tpu_torch.io.datasets import make_city_trees, make_sphere_landmarks
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3
from slampp_tpu_torch.ops import _cuda
from slampp_tpu_torch.ops import schur_kernels as sk
from slampp_tpu_torch.ops.segments import grouped_segsum_first, plan_grouped_segments
from slampp_tpu_torch.ops.small_blocks import inverse_spd_small
from _cuda_host import host_library  # tests/ is on the path of every test module

torch.set_num_threads(1)
GRAPHS = ("sim3", "se3", "se2")
DIMS = [(bs, dl) for bs in sk.POSE_DIMS for dl in sk.LANDMARK_DIMS]
PRIOR = "test_pose3d_prior"


@pytest.fixture(scope="module")
def pose_prior():
    """A unary SE(3) pose edge type (z - x, Jacobian -I), registered while
    the module's tests run."""
    TYPE_REGISTRY["edge"][PRIOR] = EdgeType(
        name=PRIOR, vertex_types=("pose3d",), res_dim=6, meas_dim=6,
        error_fn=lambda xs, z: z - xs[0],
        jacobian_fn=lambda xs, z: (z - xs[0], (-torch.eye(6, dtype=z.dtype).expand(
            z.shape[0], 6, 6),)))
    yield
    del TYPE_REGISTRY["edge"][PRIOR]


def _text_system(text):
    with g2o_file(text) as path:
        return build_system(parse_file(path))


@functools.lru_cache(maxsize=None)
def _graph_system(name):
    if name == "sim3":
        return embed_ba_system_sim3(venice_ba_system(10, 300, 4))
    if name == "se2":
        return _text_system(make_city_trees(n_poses=120, n_landmarks=30, seed=1)[0])
    system = _text_system(make_sphere_landmarks(n_poses=60, n_rings=3, n_landmarks=30,
                                                obs_radius=15.0)[0])
    rng = np.random.default_rng(0)
    for v in (3, 17, 40):
        z = system.vertex_state(v) + rng.normal(0, 0.01, 6)
        system.add_edge(PRIOR, (v,), z, np.eye(6) * 4.0)
    return system


def _engine(name, alpha=0.1):
    """(solver, its edge terms, BD) of the graph on the CPU: BD = B Dinv as
    the engine's ``ss.landmarks`` forms it at damping ``alpha``."""
    system = _graph_system(name)
    ss = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    ss.symbolic()
    terms = ss._edge_terms(system.snapshot("cpu"))
    p, B = ss.plan, terms[9]
    D = grouped_segsum_first(terms[7], p.lm_grp) + alpha * torch.eye(p.dl, dtype=torch.float64)
    if p.anchor_kind == "landmark":
        da = torch.arange(p.anchor_dim)
        D[p.anchor_idx, da, da] += p.anchor_info
    BD = torch.einsum("eij,ejk->eik", B, inverse_spd_small(D)[p.pl_lm])
    return ss, terms, BD


def _routing_formula(ss, Hii, Hjj, Hij, Hpp, BD, B):
    """The routing tables' formula: [Hii | Hjj | Hij (transposed where
    flagged) | Hpp | the pair corrections of all M2 ordered pairs] summed in
    the grouped segments of ``src_perm`` / ``src_starts`` / ``src_ends``,
    one row per hit slot in slot order."""
    T, n_pp = ss.tables, Hii.shape[0]
    tf = torch.from_numpy(T["src_tflag"][2 * n_pp:3 * n_pp] > 0)
    Hij = torch.where(tf[:, None, None], Hij.transpose(1, 2), Hij)
    pc = -torch.einsum("tik,tjk->tij", BD[torch.from_numpy(T["pair_e"])],
                       B[torch.from_numpy(T["pair_f"])])
    contribs = torch.cat([Hii, Hjj, Hij, Hpp, pc])
    n = contribs.shape[0]
    grp = plan_grouped_segments(T["src_starts"], T["src_ends"], n,
                                remap=np.append(T["src_perm"], n))
    return grouped_segsum_first(contribs, grp)


def _bound(Hii, Hjj, Hij, Hpp, BD, B, table):
    """Per entry (n_s + dl) 2^-52 S (module docstring), on the table's
    operands."""
    z = lambda t: torch.zeros_like(t)  # noqa: E731
    heads = sk.slot_sums_plain(Hii.abs(), Hjj.abs(), Hij.abs(), Hpp.abs(), z(BD), z(B), table)
    pairs = -sk.slot_sums_plain(z(Hii), z(Hjj), z(Hij), z(Hpp), BD.abs(), B.abs(), table)
    n_s = torch.zeros(table.out.shape[0], dtype=torch.float64, device=table.out.device)
    n_s[table.out.long()] = (torch.diff(table.hptr) + torch.diff(table.pptr)).double()
    return (n_s[:, None, None] + B.shape[2]) * 2.0 ** -52 * (heads + pairs)


def _within(got, want, bound):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float64
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _synthetic(bs, dl, seed=0, n_pp=5, n_pl=60, n_slots=13):
    """Random blocks and rows and a random table over them: slots of 0 to
    90 head blocks (some transposed) and 0 to 110 pairs, so that each
    crosses a 32-term chunk, one slot without heads and one without pairs."""
    rng = np.random.default_rng(seed)
    blocks = [torch.as_tensor(rng.normal(size=(n, bs, bs))) for n in (n_pp, n_pp, n_pp, n_pl)]
    BD, B = (torch.as_tensor(rng.normal(size=(n_pl, bs, dl))) for _ in range(2))
    nh = rng.integers(0, 90, n_slots)
    npr = rng.integers(0, 110, n_slots)
    nh[0], npr[1] = 0, 0
    heads = rng.integers(0, 3 * n_pp + n_pl, int(nh.sum()))
    heads = np.where(rng.random(len(heads)) < 0.3, ~heads, heads)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    table = sk.SlotTable(
        out=i32(rng.permutation(n_slots)), hptr=i32(np.concatenate([[0], np.cumsum(nh)])),
        heads=i32(heads), pptr=i32(np.concatenate([[0], np.cumsum(npr)])),
        pair_e=i32(rng.integers(0, n_pl, int(npr.sum()))),
        pair_f=i32(rng.integers(0, n_pl, int(npr.sum()))))
    return (*blocks, BD, B), table


@functools.lru_cache(maxsize=None)
def _host_kernel_library():
    """csrc/schur_kernels.cu built for the host (``tests/_cuda_host.py``),
    bound through ctypes as ``ops/_cuda.load`` binds the card's library."""
    lib = host_library(_cuda._SCHUR_SOURCE, 1)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.slampp_slot_sums_f64.argtypes = [i32, i32] + [ptr] * 12 + [i32, i32, ptr, ptr]
    return lib


def _host_run(Hii, Hjj, Hij, Hpp, BD, B, table):
    """One launch of the kernel's host build on CPU operands."""
    lib = _host_kernel_library()
    arrays = [np.ascontiguousarray(t.numpy()) for t in (Hii, Hjj, Hij, Hpp, BD, B, *table[:6])]
    bs, dl = B.shape[1:]
    n_slots = table.out.shape[0]
    out = np.full((n_slots, bs, bs), np.nan)
    assert lib.slampp_slot_sums_f64(bs, dl, *(a.ctypes.data if a.size else None for a in arrays),
                                    Hii.shape[0], n_slots, out.ctypes.data, None) == 0
    return torch.as_tensor(out)


# ------------------------------------------------------------------------ CPU


@pytest.mark.parametrize("name", GRAPHS)
def test_table_holds_each_slot_in_routing_order(name, pose_prior):
    """Table slot s sums into hit slot ``out[s]`` exactly the contributions
    the routing tables send there, in their order: its head blocks (Hij
    coded transposed where ``src_tflag`` says), then its kept pairs; the
    diagonal slots come first."""
    ss, terms, _ = _engine(name)
    p, T, tab = ss.plan, ss.tables, ss.plan.slots
    n_pp, n_pl = terms[0].shape[0], terms[5].shape[0]
    pair_off = 3 * n_pp + n_pl
    key = {(int(e), int(f)): t for t, (e, f) in enumerate(zip(T["pair_e"], T["pair_f"]))}
    assert sorted(tab.out.tolist()) == list(range(len(T["src_starts"])))
    flipped = 0
    for s, k in enumerate(tab.out.tolist()):
        h = tab.heads[tab.hptr[s]:tab.hptr[s + 1]].long()
        flip = h < 0
        flipped += int(flip.sum())
        c = torch.where(flip, ~h, h).tolist()
        for e, f in zip(tab.pair_e[tab.pptr[s]:tab.pptr[s + 1]].tolist(),
                        tab.pair_f[tab.pptr[s]:tab.pptr[s + 1]].tolist()):
            c.append(pair_off + key[(e, f)])
        want = T["src_perm"][T["src_starts"][k]:T["src_ends"][k]]
        np.testing.assert_array_equal(c, want)
        np.testing.assert_array_equal(flip.numpy(), T["src_tflag"][want[:len(h)]] > 0)
    assert (flipped > 0) == (name != "sim3")  # the pose graphs have odometry edges
    # the diagonal slots first: fine slots 0 .. n_p - 1 are the diagonal blocks
    diag = (p.slot_inv[:p.n_p]).tolist()
    assert sorted(tab.out[:p.n_p].tolist()) == sorted(diag)
    assert tab.pair_e.dtype == tab.heads.dtype == torch.int32 and p.pair_e is tab.pair_e


@pytest.mark.parametrize("name", GRAPHS)
def test_plain_matches_routing_formula(name, pose_prior):
    """The slot-major table with the plain version against the routing
    tables' formula: within the any-order bound (and nothing launched)."""
    ss, terms, BD = _engine(name)
    Hii, Hjj, Hij, Hpp, B = terms[0], terms[1], terms[2], terms[5], terms[9]
    sk.reset_launches()
    got = sk.slot_sums(Hii, Hjj, Hij, Hpp, BD, B, ss.plan.slots)
    assert sk.launches == {"slot_sums": 0}
    want = _routing_formula(ss, Hii, Hjj, Hij, Hpp, BD, B)
    _within(got, want, _bound(Hii, Hjj, Hij, Hpp, BD, B, ss.plan.slots))


def test_damped_step_matches_routing_formula(pose_prior, monkeypatch):
    """The SE(3) graph's damped step, its dx and denominator, against the
    engine with the routing tables' formula in place of ``slot_sums``:
    within 1e-12 relative."""
    system = _graph_system("se3")
    ss = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    g = system.snapshot("cpu")
    ss.ensure_symbolic()
    dx, gvec, chi2, _ = ss._solve_from_terms(g, ss._edge_terms(g), 0.05)
    monkeypatch.setattr(sk, "slot_sums", lambda *a: _routing_formula(ss, *a[:6]))
    dx0, gvec0, chi20, _ = ss._solve_from_terms(g, ss._edge_terms(g), 0.05)
    assert float((dx - dx0).norm()) <= 1e-12 * float(dx0.norm())
    assert torch.equal(gvec, gvec0) and torch.equal(chi2, chi20)


@pytest.mark.parametrize("bs,dl", DIMS)
def test_kernel_source_on_host(bs, dl):
    """The kernel's own source, run on the host (its warps' chunks of 32
    terms, the staging, the lanes' partial sums and their fixed-order
    sum), against the plain version at every dim pair it is built for."""
    ops, table = _synthetic(bs, dl, seed=bs * 10 + dl)
    _within(_host_run(*ops, table), sk.slot_sums_plain(*ops, table), _bound(*ops, table))


@pytest.mark.parametrize("name", GRAPHS)
def test_kernel_source_in_engine(name, pose_prior, monkeypatch):
    """The kernel's host build as the engine's ``slot_sums``: the damped
    step's dx within 1e-10 of the plain version's (relative)."""
    system = _graph_system(name)
    ss = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    g = system.snapshot("cpu")
    ss.ensure_symbolic()
    dx0 = ss._solve_from_terms(g, ss._edge_terms(g), 0.05)[0]
    monkeypatch.setattr(sk, "slot_sums", _host_run)
    dx = ss._solve_from_terms(g, ss._edge_terms(g), 0.05)[0]
    assert float((dx - dx0).norm()) <= 1e-10 * float(dx0.norm())


# ------------------------------------------------------------------ CUDA / gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, ops, table):
    return tuple(t.to(dev) for t in ops), table.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,dl", DIMS)
def test_kernel_matches_plain(cuda, bs, dl):
    """The kernel on the card against the plain version at every dim pair
    it is built for, within the any-order bound; one launch a call."""
    ops, table = _on(cuda, *_synthetic(bs, dl, seed=bs * 10 + dl, n_pl=2000, n_slots=300))
    sk.reset_launches()
    got = sk.slot_sums(*ops, table)
    assert sk.launches == {"slot_sums": 1}
    _within(got.cpu(), sk.slot_sums_plain(*ops, table).cpu(), _bound(*ops, table).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRAPHS)
def test_kernel_matches_plain_graphs(cuda, name, pose_prior):
    """The kernel on the engine's table and terms of each graph against the
    plain version, within the any-order bound."""
    ss, terms, BD = _engine(name)
    ops = (terms[0], terms[1], terms[2], terms[5], BD, terms[9])
    ops, table = _on(cuda, ops, ss.plan.slots._replace(grp=None))
    got = sk.slot_sums(*ops, table).cpu()
    want = sk.slot_sums_plain(*(t.cpu() for t in ops), ss.plan.slots)
    _within(got, want, _bound(*(t.cpu() for t in ops), ss.plan.slots))


@pytest.mark.gpu
def test_kernel_is_bitwise_repeatable(cuda):
    """Two launches on the same operands give the same bits."""
    ops, table = _on(cuda, *_synthetic(7, 3, n_pl=5000, n_slots=2000))
    assert torch.equal(sk.slot_sums(*ops, table), sk.slot_sums(*ops, table))


@pytest.mark.gpu
def test_damped_step_launches_once(cuda, pose_prior):
    """The engine's damped step on the card launches the kernel once."""
    system = _graph_system("sim3")
    ss = SparseSchurSolver(system, device=cuda)
    ss.ensure_symbolic()
    assert ss.plan.slots.grp is None
    sk.reset_launches()
    ss.damped_step(system.snapshot(cuda), 1e-3)
    assert sk.launches == {"slot_sums": 1}


@pytest.mark.gpu
def test_kernel_refuses(cuda):
    """CPU / CUDA mixed operands, a float32 block, a non-contiguous row
    array, an int64 table and dims it is not built for raise; nothing is
    launched."""
    ops, table = _on(cuda, *_synthetic(7, 3))
    sk.reset_launches()
    with pytest.raises(ValueError):
        sk.slot_sums(*ops[:5], ops[5].cpu(), table)
    with pytest.raises(ValueError):
        sk.slot_sums(*ops, table._replace(pair_e=table.pair_e.cpu()))
    with pytest.raises(TypeError):
        sk.slot_sums(ops[0], ops[1], ops[2], ops[3].float(), *ops[4:], table)
    with pytest.raises(ValueError):
        sk.slot_sums(*ops[:4], ops[4].transpose(1, 2).contiguous().transpose(1, 2), ops[5],
                     table)
    with pytest.raises(TypeError):
        sk.slot_sums(*ops, table._replace(heads=table.heads.long()))
    ops4, table4 = _on(cuda, *_synthetic(4, 3))
    with pytest.raises(ValueError):
        sk.slot_sums(*ops4, table4)
    assert sk.launches == {"slot_sums": 0}
