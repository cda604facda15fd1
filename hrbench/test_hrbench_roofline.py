"""The byte counts behind k3_roofline.pt, from shapes alone."""

from hrbench import roofline


def test_k3_bytes_from_shapes():
    R, rows = 8_294_400, 69_905
    assert roofline.k3_bytes(R, rows) == R * 28 + rows * 512 + R * 12


def test_peaks():
    p = roofline.peak("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["fp32_flops_per_s"] == 67e12
