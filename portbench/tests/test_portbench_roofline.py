"""The roofline's counts from shapes against values worked by hand."""

import pytest

from portbench import roofline

CHOL_SEP = ((1, 3952, 3952),)


def test_cholesky_separator_f32_is_bound_by_operations():
    # 3952^3 / 3 = 61,723,537,408 / 3 operations over 67e12 / s
    ops, nbytes = roofline.work("cholesky", CHOL_SEP, "float32")
    assert ops == pytest.approx(61_723_537_408 / 3)
    # (3952 * 3953 / 2 + 3952^2) * 4 = (7,811,128 + 15,618,304) * 4
    assert nbytes == 93_717_728
    assert roofline.bound_of_call("cholesky", CHOL_SEP, "float32") == pytest.approx(
        61_723_537_408 / 3 / 67e12)


def test_cholesky_part_frames_f64_is_bound_by_bytes():
    # 40 x 320: (51,360 + 102,400) * 8 * 40 = 49,203,200 bytes
    ops, nbytes = roofline.work("cholesky", ((40, 320, 320),), "float64")
    assert nbytes == 49_203_200 and ops == pytest.approx(40 * 320 ** 3 / 3)
    assert roofline.bound_of_call("cholesky", ((40, 320, 320),), "float64") == pytest.approx(
        49_203_200 / 3.35e12)


def test_trsm_counts():
    # (1, 3952, 8) f64: 3952^2 * 8 = 124,946,432 operations;
    # (7,811,128 + 2 * 3952 * 8) * 8 = 62,994,880 bytes: bytes bound it
    ops, nbytes = roofline.work("trsm", ((1, 3952, 3952), (1, 3952, 8)), "float64")
    assert ops == 124_946_432 and nbytes == 62_994_880
    assert roofline.bound_of_call("trsm", ((1, 3952, 3952), (1, 3952, 8)),
                                  "float64") == pytest.approx(62_994_880 / 3.35e12)
    # (40, 320, 176) f32: 40 * 320^2 * 176 = 720,896,000 operations over
    # 40 * (51,360 + 112,640) * 4 = 26,240,000 bytes: operations bound it
    assert roofline.bound_of_call("trsm", ((40, 320, 320), (40, 320, 176)),
                                  "float32") == pytest.approx(720_896_000 / 67e12)


def test_roofline_reader_sums_bounds_over_device_time():
    from portbench.readers import roofline as reader

    class View:
        def calls(self, fn):
            return {"chol_batched": [(CHOL_SEP, "float32", 3e-3)] * 2}.get(fn, [])

    share = reader.read(View(), 10, "m", {"chol_batched": "cholesky", "trsm_lower_batched": "trsm"})
    assert share == pytest.approx(100.0 * 61_723_537_408 / 3 / 67e12 / 3e-3)
    assert reader.read(View(), 10, "m", {"trsm_lower_batched": "trsm"}) is None
    assert reader.wraps("m", {"chol_batched": "cholesky"}) == [("m", "chol_batched")]
