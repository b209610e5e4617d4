"""The frozen generators equal the port's at small sizes, while the two
agree: the benchmark's inputs move only when a later change to the
benchmark moves them."""

import numpy as np
import pytest

from portbench.traffic import sphere, venice
from slampp_tpu_torch.io import datasets


@pytest.mark.parametrize("seed", [0, 2147483659])
def test_sphere_text_byte_for_byte(seed):
    assert sphere.sphere_text(150, seed=seed) == datasets.sphere_text(150, seed=seed)
    assert sphere.sphere_text(120, 4, seed=seed) == datasets.sphere_text(120, 4, seed=seed)


@pytest.mark.parametrize("seed", [0, 2147483659])
def test_venice_arrays_array_for_array(seed):
    kw = dict(n_cams=24, n_points=500, mean_track=6, seed=seed)
    ours, theirs = venice.make_venice_ba_arrays(**kw), datasets.make_venice_ba_arrays(**kw)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_venice_generate_moves_only_the_cameras_and_repeats():
    kw = dict(n_cams=24, n_points=500, mean_track=6)
    plain = venice.make_venice_ba_arrays(seed=2147483659, **kw)
    a = venice.generate(2147483659, cam_rot_sigma=0.002, cam_t_sigma=0.03, **kw)
    b = venice.generate(2147483659, cam_rot_sigma=0.002, cam_t_sigma=0.03, **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for k, v in zip(("points", "obs_cam", "obs_pt", "uv", "info"), plain[1:6]):
        np.testing.assert_array_equal(a[k], v)
    shift = np.abs(a["cams"][:, 0:3] - plain[0][:, 0:3])
    assert 1e-4 < shift.max() < 0.2
    # the rotation each camera was turned by (axis-angle may wrap near pi)
    turn = [2 * np.arccos(min(1.0, abs(sphere._np_aa_to_quat(x) @ sphere._np_aa_to_quat(y))))
            for x, y in zip(a["cams"][:, 3:6], plain[0][:, 3:6])]
    assert 1e-4 < max(turn) < 0.02
    np.testing.assert_array_equal(a["cams"][:, 6:], plain[0][:, 6:])
    still = venice.generate(2147483659, **kw)
    np.testing.assert_array_equal(still["cams"], plain[0])


def test_sphere_generate_is_the_text():
    assert sphere.generate(7, n_poses=100, n_rings=2) == sphere.sphere_text(100, 2, seed=7)
