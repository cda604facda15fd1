"""The yardstick of the kernels: the card's published peaks and the bytes
each hand kernel must move, counted from the sizes of its inputs and
outputs alone (each input read once, each output written once), so that a
change to a kernel cannot make the count stale.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit (the run prints the card's own limit beside its numbers)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

F32 = 4
I32 = 4


def peak(kind: str) -> dict:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def k3_bytes(rays: int, table_rows: int) -> int:
    """K3 (the bvh16 walk): o, d (R, 3) f32 and t_max (R,) f32 in, the
    (I + L, 128) f32 table read once; best_t (R,) f32, best_tri (R,) i32 and
    steps (R,) i32 out."""
    return rays * (3 + 3 + 1) * F32 + table_rows * 128 * F32 + rays * (F32 + 2 * I32)
