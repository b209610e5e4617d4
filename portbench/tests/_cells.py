"""Sizes at which the harness's tests drive the cells on the CPU."""

TINY = {
    "sphere2500.gn_mixed": {"generator": {"n_poses": 200, "n_rings": 4}},
    "sphere2500.gn_f64": {"generator": {"n_poses": 200, "n_rings": 4}},
    "venice871.lm": {"generator": {"n_cams": 20, "n_points": 400, "mean_track": 5}},
}
