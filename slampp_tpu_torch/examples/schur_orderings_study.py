"""Schur-ordering FLOP study, the slam_schur_orderings research app
(counterpart of ``examples/schur_orderings_study.py``; reference
src/slam_schur_orderings/Main.cpp, the HPC'17 paper driver).

Given a landmark problem it counts the exact FLOPs of
  * plain sparse block Cholesky of lambda under several fill-reducing
    orderings (natural / minimum degree / RCM / nested dissection,
    Main.cpp:368-430,473),
  * one-level Schur elimination of the landmarks with the reduced camera
    system factored under a sub-ordering (Main.cpp:546-630),
  * MIS-based orderings where the eliminated set is a maximal independent
    set of the whole graph (MIS_FF, Main.cpp:703-760),
  * nested Schur: recursively eliminating an independent set of the
    reduced system (the "ordering3" experiments).

The instrument is a host-side symbolic block elimination (exact block fill
and per-block-operation FLOP formulas: chol d^3/3, trsm d_i d_j^2, GEMM
update 2 d_i d_k d_j), the role CFLOPCountingDouble plays in the reference.
It runs on the host; ``--device`` is taken for the examples' common
interface and needs no card.

    python -m slampp_tpu_torch.examples.schur_orderings_study [--poses 300] [--landmarks 90] [--device cpu]
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args


def chol_flops(n, pairs, dims, order=None):
    """Exact FLOPs (+fill) of sparse block Cholesky of an n-block SPD matrix
    with off-diagonal block pattern ``pairs`` (i>j), per-block dims ``dims``,
    eliminated in ``order`` (permutation old->elimination position)."""
    if order is None:
        order = np.arange(n)
    pos = np.empty(n, np.int64)
    pos[np.asarray(order)] = np.arange(n)
    # renumber into elimination positions
    cols = [set() for _ in range(n)]
    for i, j in pairs:
        a, b = pos[i], pos[j]
        if a == b:
            continue
        hi, lo = (a, b) if a > b else (b, a)
        cols[lo].add(hi)
    d = np.asarray(dims, float)[np.argsort(pos)]  # dims by elimination pos
    flops = 0.0
    fill = 0
    for j in range(n):
        rows = np.fromiter(cols[j], np.int64, len(cols[j]))
        rows.sort()
        dj = d[j]
        flops += dj**3 / 3.0  # chol of the diagonal block
        flops += float(np.sum(d[rows])) * dj * dj  # trsm per off-diag block
        # symmetric rank-k updates: every pair (a, b) in rows, a >= b
        dr = d[rows]
        s1 = float(dr.sum())
        flops += (s1 * s1 + float((dr * dr).sum())) * dj  # 2*sum_{a>=b} da db * dj
        fill += len(rows)
        for idx in range(len(rows)):
            cols[rows[idx]].update(rows[idx + 1:].tolist())
    return flops, fill


def backsolve_flops(n, pairs, dims, order=None):
    """FLOPs of the two triangular solves with the FILLED factor."""
    # fill pattern comes out of a symbolic pass; reuse chol_flops' elimination
    if order is None:
        order = np.arange(n)
    pos = np.empty(n, np.int64)
    pos[np.asarray(order)] = np.arange(n)
    cols = [set() for _ in range(n)]
    for i, j in pairs:
        a, b = pos[i], pos[j]
        if a == b:
            continue
        hi, lo = (a, b) if a > b else (b, a)
        cols[lo].add(hi)
    d = np.asarray(dims, float)[np.argsort(pos)]
    flops = 0.0
    for j in range(n):
        rows = np.fromiter(cols[j], np.int64, len(cols[j]))
        rows.sort()
        flops += d[j] * d[j]  # diag triangular solve (x2 passes below)
        flops += 2.0 * float(np.sum(d[rows])) * d[j]
        for idx in range(len(rows)):
            cols[rows[idx]].update(rows[idx + 1:].tolist())
    return 2.0 * flops  # forward + backward


def schur_flops(elim, keep, pairs, dims, sub_order_fn=None, depth=1):
    """FLOPs of eliminating block set ``elim`` (must be independent in the
    block graph) and factoring the reduced system over ``keep``.

    Returns (total_flops, sc_pairs, sc_dims, keep_ids) — callers can recurse
    on the reduced system (nested Schur).
    """
    elim = set(elim)
    keep_ids = [v for v in keep]
    kpos = {v: i for i, v in enumerate(keep_ids)}
    dims = np.asarray(dims, float)
    adj_e = {}  # eliminated block -> list of kept neighbors
    sc_pairs = set()
    flops = 0.0
    for i, j in pairs:
        ii, jj = (i, j) if i != j else (i, j)
        ei, ej = ii in elim, jj in elim
        if ei and ej:
            raise ValueError("elim set not independent")
        if ei:
            adj_e.setdefault(ii, []).append(jj)
            flops += 2.0 * dims[jj] * dims[ii] * dims[ii]  # U_l * Dinv_l
        elif ej:
            adj_e.setdefault(jj, []).append(ii)
            flops += 2.0 * dims[ii] * dims[jj] * dims[jj]
        else:
            sc_pairs.add((kpos[ii], kpos[jj]))
    for l, nbrs in adj_e.items():
        flops += dims[l] ** 3  # Dinv_l (inverse of the diagonal block)
        # pair products (U_a Dinv) U_b^T over the neighbor clique
        dn = dims[np.asarray(nbrs)]
        s1 = float(dn.sum())
        flops += (s1 * s1 + float((dn * dn).sum())) * dims[l]
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                x, y = kpos[nbrs[a]], kpos[nbrs[b]]
                if x != y:
                    sc_pairs.add((max(x, y), min(x, y)))
    sc_dims = dims[np.asarray(keep_ids)] if keep_ids else np.zeros(0)
    n_k = len(keep_ids)
    order = sub_order_fn(n_k, sc_pairs) if sub_order_fn else None
    cf, _ = chol_flops(n_k, sc_pairs, sc_dims, order)
    return flops + cf, sc_pairs, sc_dims, keep_ids


def main(argv=None):
    def add(ap):
        ap.add_argument("--poses", type=int, default=300)
        ap.add_argument("--landmarks", type=int, default=90)

    args = parse_args(argv, __doc__.splitlines()[0], add, host_only=True)

    from slampp_tpu_torch.core.ordering import (
        block_adjacency,
        min_degree_ordering,
        mis_first_fit,
        nested_dissection_ordering,
        rcm_ordering,
    )
    from slampp_tpu_torch.graph.types import get_vertex_type
    from slampp_tpu_torch.io.datasets import make_city_trees
    from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file

    text, _ = make_city_trees(
        n_poses=args.poses, n_landmarks=args.landmarks, seed=0, obs_kind="rb"
    )
    with g2o_file(text) as path:
        system = build_system(parse_file(path))

    # block graph of lambda
    vids = list(system._vorder)
    vpos = {v: i for i, v in enumerate(vids)}
    n = len(vids)
    dims = np.array(
        [get_vertex_type(system.vertex_index[v][0]).dim for v in vids], float
    )
    is_lm = np.array(
        [get_vertex_type(system.vertex_index[v][0]).is_landmark for v in vids]
    )
    pairs = set()
    for tname in system.edge_type_names:
        for e_vids in system._edges[tname]["vids"]:
            for a in range(len(e_vids)):
                for b in range(a + 1, len(e_vids)):
                    i, j = vpos[e_vids[a]], vpos[e_vids[b]]
                    pairs.add((max(i, j), min(i, j)))
    print(f"system: {n} blocks ({int(is_lm.sum())} landmarks), "
          f"{len(pairs)} off-diagonal blocks")

    adj = block_adjacency(n, sorted(pairs))
    results = {}

    # --- plain sparse Cholesky under fill-reducing orderings
    for name, order in (
        ("chol natural", np.arange(n)),
        ("chol RCM", rcm_ordering(adj)),
        ("chol min-degree", min_degree_ordering(adj)),
        ("chol nested-dissection", nested_dissection_ordering(adj)),
    ):
        cf, fill = chol_flops(n, pairs, dims, order)
        sf = backsolve_flops(n, pairs, dims, order)
        results[name] = (cf + sf, fill)

    def mindeg_sub(nk, sc_pairs):
        return min_degree_ordering(block_adjacency(nk, sorted(sc_pairs)))

    # --- guided Schur: eliminate the landmark set (reference 'guided')
    elim = [v for v in range(n) if is_lm[v]]
    keep = [v for v in range(n) if not is_lm[v]]
    total, sc_pairs, sc_dims, keep_ids = schur_flops(
        elim, keep, pairs, dims, sub_order_fn=mindeg_sub
    )
    results["Schur guided (landmarks)"] = (total, None)

    # --- MIS first-fit Schur: eliminate a maximal independent set of the
    #     WHOLE graph (reference MIS_FF, CSchurOrdering::t_MIS_FirstFit)
    mis = set(mis_first_fit(adj).tolist())
    total, _, _, _ = schur_flops(
        sorted(mis), [v for v in range(n) if v not in mis], pairs, dims,
        sub_order_fn=mindeg_sub,
    )
    results["Schur MIS first-fit"] = (total, None)

    # --- nested Schur: eliminate landmarks, then an MIS of the REDUCED pose
    #     graph, then min-degree on the rest (the 'ordering3' experiments)
    total1, sc_pairs, sc_dims, keep_ids = schur_flops(
        elim, keep, pairs, dims, sub_order_fn=None
    )
    # recompute without the final chol so we can nest: redo pieces
    elim_fl = total1 - chol_flops(len(keep_ids), sc_pairs, sc_dims)[0]
    adj2 = block_adjacency(len(keep_ids), sorted(sc_pairs))
    mis2 = set(mis_first_fit(adj2).tolist())
    total2, _, _, _ = schur_flops(
        sorted(mis2), [v for v in range(len(keep_ids)) if v not in mis2],
        sc_pairs, sc_dims, sub_order_fn=mindeg_sub,
    )
    results["Schur nested (lm, then pose-MIS)"] = (elim_fl + total2, None)

    best = min(v[0] for v in results.values())
    print(f"\n{'scheme':34s} {'FLOPs':>14s} {'vs best':>8s}")
    for name, (fl, fill) in results.items():
        extra = f"  (fill: {fill} blocks)" if fill is not None else ""
        print(f"{name:34s} {fl:14.3e} {fl / best:8.2f}x{extra}")
    return results


if __name__ == "__main__":
    main()
