"""The bvh16-walk step microbenchmarks K7-K9: wrappers of csrc/wkernels.cu,
their plain PyTorch versions and launch counters (counterparts of the
Pallas microkernels k1 / k2 / k2b of scripts/bench_wkernels.py).

- ``leaf_gather`` (K7, the leaf-step row fetch): ``iters`` repeats of
  gathering ``rows`` 512 B rows ``leaf[idx.flat[r]]`` into a (2048, 128)
  buffer; returns the buffer's first 16 rows.
- ``int_fetch`` (K8, the interior-step fetch from the (96, Ip) bf16 table)
  and ``int_fetch_hc`` (K9, the same fetch from the hc-ordered table, row
  h*96 + c = tab[c, 128h + l]): per step i and sub-row g the 96-value
  column of (idx[g] + i) % Ip; returns (1, 128) f32, the sum over g = 0..15
  (in that order) of row 0 of the last step's columns. Their kernel holds
  the table in shared memory across a thread-block cluster; the slices'
  layout is ``int_fetch_layout``.

Each kernel also writes a checksum of every value it fetched, a side output
that keeps the compiler from dropping the repeat loop (the TPU numbers were
invalid for that reason); the wrappers return it, and chip_smoke.py holds
it to the plain version's within a relative 1e-5 (the sums run in another
order).
Leaf row ids are clamped to the table (the TPU kernel's DMA would fault on
one out of range). CPU tensors take the plain versions; CUDA tensors launch
the kernels or raise."""

from __future__ import annotations

import torch

from hobbyrenderer_tpu_torch import kernels

LANE = 128
SUB = 16              # sub-rows of 128 lanes: idx is (16, 128)
RB = SUB * LANE       # the leaf buffer's rows (2048)
NCOL = 96             # interior values per column (16 child boxes x 6)

SMEM_LIMIT = 232_448  # shared bytes one CTA may use on the H100
MAX_CLUSTER = 8       # the largest portable thread-block cluster

leaf_launches = 0     # K7 launches (plain calls are not counted)
int_launches = 0      # K8
hc_launches = 0       # K9


def _check_leaf(idx, leaf, rows, iters):
    if idx.shape != (SUB, LANE) or leaf.ndim != 2 or leaf.shape[1] != LANE:
        raise ValueError(f"idx must be (16, 128) and leaf (n, 128), got {tuple(idx.shape)}, "
                         f"{tuple(leaf.shape)}")
    if not (SUB <= rows <= RB) or iters < 1:
        raise ValueError(f"rows must lie in [16, 2048] and iters >= 1, got {rows}, {iters}")


def leaf_gather(idx, leaf, rows: int, iters: int):
    """K7: (out (16, 128) f32, checksum (rows,) f32)."""
    _check_leaf(idx, leaf, rows, iters)
    if leaf.device.type == "cpu":
        return leaf_gather_reference(idx, leaf, rows, iters)
    global leaf_launches
    kernels.require(idx, "idx", torch.int32, (SUB, LANE))
    kernels.require(leaf, "leaf", torch.float32)
    dev = leaf.device
    buf = torch.empty((RB, LANE), dtype=torch.float32, device=dev)
    out = torch.empty((SUB, LANE), dtype=torch.float32, device=dev)
    checksum = torch.empty((rows,), dtype=torch.float32, device=dev)
    err = kernels.library().hr_wk_leaf_gather(
        idx.data_ptr(), leaf.data_ptr(), buf.data_ptr(), out.data_ptr(), checksum.data_ptr(),
        int(rows), int(iters), int(leaf.shape[0]), kernels.stream_handle(dev))
    kernels.check(err, "hr_wk_leaf_gather")
    leaf_launches += 1
    return out, checksum


def leaf_gather_reference(idx, leaf, rows: int, iters: int):
    """Plain version of K7: every step gathers the same rows, so the buffer's
    first 16 rows are leaf[idx.flat[:16]]; the checksum is iters x each
    gathered row's sum."""
    src = torch.clamp(idx.reshape(-1)[:rows].to(torch.int64), 0, leaf.shape[0] - 1)
    gathered = leaf[src]
    return gathered[:SUB].clone(), gathered.sum(1) * iters


def _cols(idx, iters: int, Ip: int):
    """The last step's column of every (sub-row, lane): (16, 128) int64."""
    return torch.remainder(idx.to(torch.int64) + (iters - 1), Ip)


def _sum_subrows(vals):
    """acc = 0; acc = acc + vals[g] for g = 0..15, as the TPU kernel adds."""
    acc = torch.zeros((LANE,), dtype=torch.float32, device=vals.device)
    for g in range(SUB):
        acc = acc + vals[g]
    return acc[None]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _layout(Ip: int, cluster: int):
    cols = _ceil_div(_ceil_div(Ip, cluster), 8) * 8      # runs of 8 (16-byte staging loads)
    return dict(cluster=cluster, cols=cols, pitch=NCOL,
                smem=cols * NCOL * 2 + SUB * 4)          # the slice, then row 0 of 16 sub-rows


def int_fetch_layout(Ip: int, hc: bool) -> dict:
    """K8's (hc False) or K9's (hc True) shared-memory layout: the table in
    slices across a thread-block cluster of ``cluster`` CTAs, CTA rank r
    holding columns [r * cols, (r + 1) * cols) column-major (value c of its
    local column j at j * pitch + c), and ``smem`` shared bytes a CTA. A
    column's 96 values are 192 contiguous bytes, read as twelve 16-byte
    pieces, which an 8-lane phase takes from 32 distinct banks. One CTA
    holds the whole table where it fits (Ip 512), else a cluster of 8. The
    hc table (K9) is sliced the same way: its 8-column runs never cross a
    128-column block. Raises when the table does not fit a cluster of 8."""
    if hc and Ip % LANE:
        raise ValueError(f"the hc table needs Ip a multiple of 128, got {Ip}")
    lay = _layout(Ip, 1)
    if lay["smem"] > SMEM_LIMIT:
        lay = _layout(Ip, MAX_CLUSTER)
    if lay["smem"] > SMEM_LIMIT:
        raise ValueError(f"a (96, {Ip}) table needs {lay['smem']} shared bytes a CTA in a "
                         f"cluster of {MAX_CLUSTER}, over {SMEM_LIMIT}")
    return lay


def _int_fetch(idx, tab, iters: int, Ip: int, hc: bool):
    global int_launches, hc_launches
    kernels.require(idx, "idx", torch.int32, (SUB, LANE))
    kernels.require(tab, "tab", torch.bfloat16)
    lay = int_fetch_layout(Ip, hc)
    dev = tab.device
    out = torch.empty((LANE,), dtype=torch.float32, device=dev)
    checksum = torch.empty((SUB, LANE), dtype=torch.float32, device=dev)
    err = kernels.library().hr_wk_int_fetch(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), checksum.data_ptr(), int(iters),
        int(Ip), int(hc), lay["cluster"], lay["cols"], lay["pitch"], lay["smem"],
        kernels.stream_handle(dev))
    kernels.check(err, "hr_wk_int_fetch")
    if hc:
        hc_launches += 1
    else:
        int_launches += 1
    return out[None], checksum


def _check_int(idx, tab, iters, Ip, hc):
    want = (Ip // LANE * NCOL, LANE) if hc else (NCOL, Ip)
    if idx.shape != (SUB, LANE) or tuple(tab.shape) != want or iters < 1:
        raise ValueError(f"idx must be (16, 128), tab {want} and iters >= 1, got "
                         f"{tuple(idx.shape)}, {tuple(tab.shape)}, {iters}")
    if hc and Ip % LANE:
        raise ValueError(f"the hc table needs Ip a multiple of 128, got {Ip}")


def int_fetch(idx, tab, iters: int, Ip: int):
    """K8 on the (96, Ip) bf16 table: (out (1, 128) f32, checksum (16, 128))."""
    _check_int(idx, tab, iters, Ip, False)
    if tab.device.type == "cpu":
        return int_fetch_reference(idx, tab, iters, Ip)
    return _int_fetch(idx, tab, iters, Ip, hc=False)


def int_fetch_hc(idx, tab_hc, iters: int, Ip: int):
    """K9 on the hc-ordered (Ip/128 * 96, 128) bf16 table: as ``int_fetch``."""
    _check_int(idx, tab_hc, iters, Ip, True)
    if tab_hc.device.type == "cpu":
        return int_fetch_hc_reference(idx, tab_hc, iters, Ip)
    return _int_fetch(idx, tab_hc, iters, Ip, hc=True)


def int_fetch_reference(idx, tab, iters: int, Ip: int):
    """Plain version of K8 (row 0 of the last step's columns; the checksum
    sums every step's 96-value columns)."""
    t = tab.to(torch.float32)
    steps = torch.remainder(idx.to(torch.int64)[None] + torch.arange(
        iters, device=idx.device)[:, None, None], Ip)             # (iters, 16, 128)
    checksum = t.sum(0)[steps].sum(0)
    return _sum_subrows(t[0][_cols(idx, iters, Ip)]), checksum


def int_fetch_hc_reference(idx, tab_hc, iters: int, Ip: int):
    """Plain version of K9: column col of the hc table is rows
    (col // 128) * 96 + c, lane col % 128."""
    t = tab_hc.to(torch.float32).reshape(Ip // LANE, NCOL, LANE)
    steps = torch.remainder(idx.to(torch.int64)[None] + torch.arange(
        iters, device=idx.device)[:, None, None], Ip)
    checksum = t.sum(1)[steps // LANE, steps % LANE].sum(0)
    col = _cols(idx, iters, Ip)
    return _sum_subrows(t[col // LANE, 0, col % LANE]), checksum


def hc_table(tab):
    """(96, Ip) -> the hc-ordered (Ip/128 * 96, 128) table: row h*96 + c =
    tab[c, 128h + l] (bench_wkernels.py's reordering)."""
    n, Ip = tab.shape
    return tab.reshape(n, Ip // LANE, LANE).permute(1, 0, 2).reshape(Ip // LANE * n, LANE) \
        .contiguous()
