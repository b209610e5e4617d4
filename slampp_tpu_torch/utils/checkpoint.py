"""Checkpoint / resume of a GraphSystem (counterpart of
``slampp_tpu/utils/checkpoint.py``).

A checkpoint captures the whole graph (vertex states with their const
flags, per-type edge measurements and information) plus optional scalar
metadata, as one compressed npz.  The format is the JAX package's: a file
written by either package loads in the other to the same layout, states and
edges.  The port's GraphSystem has no ``bucket_granularity`` (it snapshots
unpadded), so the writer stores the JAX package's default and the reader
ignores the field.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

# slampp_tpu/graph/system.py:133, GraphSystem(bucket_granularity=256)
JAX_BUCKET_GRANULARITY = 256


def save_checkpoint(path: str, system, extra: Optional[Dict] = None) -> None:
    """Serialize a GraphSystem (+ optional scalar metadata) to ``path``."""
    arrays = {}
    meta = {
        "unary_information": system.unary_information,
        "unary_anchor": system._unary_anchor,
        "bucket_granularity": getattr(system, "bucket_granularity", JAX_BUCKET_GRANULARITY),
        "vertex_types": [],
        "edge_types": [],
        "extra": extra or {},
    }
    for t in system.vertex_type_names:
        meta["vertex_types"].append(t)
        arrays[f"v_{t}_states"] = np.stack(system._vstates[t])
        arrays[f"v_{t}_ids"] = np.asarray(system._vids[t], np.int64)
        arrays[f"v_{t}_const"] = np.asarray([system._vconst[v] for v in system._vids[t]], bool)
    arrays["vorder"] = np.asarray(system._vorder, np.int64)
    for t in system.edge_type_names:
        meta["edge_types"].append(t)
        rec = system._edges[t]
        arrays[f"e_{t}_vids"] = np.asarray(rec["vids"], np.int64)
        arrays[f"e_{t}_meas"] = np.stack(rec["meas"])
        arrays[f"e_{t}_sigma"] = np.stack(rec["sigma_inv"])
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str):
    """Reconstruct (GraphSystem, extra) from a checkpoint file."""
    from slampp_tpu_torch.graph.system import GraphSystem

    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["__meta__"]).decode())
    system = GraphSystem(unary_information=meta["unary_information"])
    # vertices are added in their original insertion order for the same layout
    order_rank = {int(v): i for i, v in enumerate(data["vorder"])}
    pending = []
    for t in meta["vertex_types"]:
        ids = data[f"v_{t}_ids"]
        states = data[f"v_{t}_states"]
        consts = data[f"v_{t}_const"]
        for i, vid in enumerate(ids):
            pending.append((order_rank.get(int(vid), 1 << 60), t, int(vid), states[i],
                            bool(consts[i])))
    for _, t, vid, state, const in sorted(pending, key=lambda x: x[0]):
        system.add_vertex(t, vid, state, const=const)
    for t in meta["edge_types"]:
        vids = data[f"e_{t}_vids"]
        meas = data[f"e_{t}_meas"]
        sig = data[f"e_{t}_sigma"]
        for i in range(len(vids)):
            system.add_edge(t, tuple(int(v) for v in vids[i]), meas[i], sig[i])
    system._unary_anchor = meta["unary_anchor"]
    return system, meta["extra"]
