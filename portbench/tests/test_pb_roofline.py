"""The frozen bytes and operations functions equal chip_smoke.py's."""

import pytest

import pb_tiny  # noqa: F401
import chip_smoke
import pb_roofline


@pytest.mark.parametrize("n,o", [(120, 3), (120, 4), (1934, 3), (6144, 5)])
def test_tcg_bytes_ops(n, o):
    for fn in ("step_bytes_ops", "cw_bytes_ops", "dense_bytes_ops"):
        assert getattr(pb_roofline, fn)(n, o) == getattr(chip_smoke, fn)(n, o)


@pytest.mark.parametrize("args", [(270336, 24576, 3, 4, 24577),
                                  (297217, 200, 13, 8, 201),
                                  (1000, 10, 1, 8, 41)])
def test_segsum_bytes_ops(args):
    assert (pb_roofline.segsum_bytes_ops(*args)
            == chip_smoke.segsum_bytes_ops(*args))


def test_least_seconds_takes_the_larger_bound():
    assert pb_roofline.least_seconds(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert pb_roofline.least_seconds(0, 67e12, 67e12) == pytest.approx(1.0)
