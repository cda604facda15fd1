"""Texture streaming: budgeted residency over a paged device texel pool
(counterpart of hobbyrenderer_tpu/scene/streaming.py).

Three device tensors plus a host manager stand in for D3D12's tiled
resources:

- tex_pool   (tail + P*1024, 4) int64 holding the packed uint32 texel words
  (the port's convention for texel rows, ops/texture.py): the always-resident
  mip TAIL (every mip <= 32x32, dense) followed by P pool PAGES of 1024
  texels; a page backs one 32x32 tile of some (material, mip).
- page_table (V,) int64: virtual tile -> page id (-1 = absent); vt_base
  (Mat, MIPS) gives each mip's first virtual tile (static at load).
- mat_resident (Mat,) int64: finest FULLY-resident mip per material. Sampling
  clamps the requested lod to it, so a partially streamed mip is never read.

Feedback is the (Mat, MIPS) demand histogram the G-buffer resolve builds
(ops/texture.py::texture_feedback). The host policy is the JAX package's,
copied as it is: desired mip per material from feedback, upgrades scheduled
tile by tile within a per-frame budget (default 128 tiles), LRU page
recycling, downgrades only after a hysteresis window (default 1 s). A worker
thread builds the numpy upload batches; only the thread that renders touches
device tensors (``initial_tables``, ``apply_updates``)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hobbyrenderer_tpu_torch.scene.textures import MAX_MIPS, NEUTRAL, material_texel_chain

TILE = 32                    # streamed tile edge (texels)
PAGE_TEXELS = TILE * TILE
TAIL_MAX = 32                # mips <= this edge live in the always-resident tail


class StreamTables(NamedTuple):
    """Device-side streaming state (lives in SceneGPU.tex_stream); int64
    tensors."""

    tex_pool: torch.Tensor      # (tail + P*1024, 4) packed uint32 words
    page_table: torch.Tensor    # (V,) virtual tile -> page (-1 absent)
    mat_resident: torch.Tensor  # (Mat,) finest fully-resident mip
    vt_base: torch.Tensor       # (Mat, MAX_MIPS) first virtual tile (-1 tail)
    tail_off: torch.Tensor      # (Mat, MAX_MIPS) row offset of tail mips
    pool_base: int              # first pool row (= tail row count), static
    mat_tex_size: torch.Tensor  # (Mat,) top-mip edge


class _Upload(NamedTuple):
    rows: np.ndarray         # (K * 1024,) i32 pool row indices
    texels: np.ndarray       # (K * 1024, 4) u32
    page_entries: np.ndarray  # (K, 2) i32 (virtual tile, page)
    resident: np.ndarray     # (Mat,) i32 new mat_resident
    freed: List[int]         # page ids recycled by this batch


class TextureStreamer:
    """Host-side residency manager (FeedbackManager + AsyncTileIO analogue).

    sync_mode=True processes everything inline in poll() — deterministic for
    tests; the renderer uses a worker thread."""

    def __init__(self, scene, budget_pages: int = 4096,
                 tiles_per_frame: int = 128, hysteresis_s: float = 1.0,
                 sync_mode: bool = False, now_fn=time.monotonic):
        self.scene = scene
        self.budget_pages = budget_pages
        self.tiles_per_frame = tiles_per_frame
        self.hysteresis_s = hysteresis_s
        self.sync_mode = sync_mode
        self._now = now_fn            # injectable clock (tests)
        M = len(scene.materials)
        self.n_mats = M

        # ---- virtual layout (static) ----
        self._chains: List[Optional[List[np.ndarray]]] = [None] * M
        self._chain_lock = threading.Lock()
        self.mat_size = np.ones(M, np.int32)
        self.vt_base = np.full((M, MAX_MIPS), -1, np.int32)
        self.tail_off = np.zeros((M, MAX_MIPS), np.int32)
        self.tail_mip = np.zeros(M, np.int32)   # coarsest streamable mip + 1
        tail_rows: List[np.ndarray] = []
        cursor = 0
        vt_cursor = 0
        for mi in range(M):
            chain = self._chain(mi)
            if chain is None:
                self.tail_off[mi, :] = cursor
                tail_rows.append(NEUTRAL[None, :])
                cursor += 1
                self.tail_mip[mi] = 0
                continue
            S = chain[0].shape[0]
            self.mat_size[mi] = S
            last = cursor
            for li in range(MAX_MIPS):
                if li >= len(chain):
                    self.tail_off[mi, li] = last
                    continue
                Sl = chain[li].shape[0]
                if Sl <= TAIL_MAX:
                    self.tail_off[mi, li] = cursor
                    last = cursor
                    tail_rows.append(chain[li].reshape(-1, 16))
                    cursor += Sl * Sl
                else:
                    nt = (Sl // TILE) ** 2
                    self.vt_base[mi, li] = vt_cursor
                    vt_cursor += nt
            self.tail_mip[mi] = int(
                np.argmax(self.mat_size[mi] >> np.arange(MAX_MIPS) <= TAIL_MAX))
        self.n_vtiles = max(vt_cursor, 1)
        tail_u8 = (np.concatenate(tail_rows, 0) if tail_rows
                   else NEUTRAL[None, :])
        self.tail_texels = (tail_u8.reshape(-1, 4, 4).view(np.uint32)
                            .reshape(-1, 4))
        self.pool_base = self.tail_texels.shape[0]

        # ---- residency state (host mirror) ----
        self.resident = self.tail_mip.copy()     # finest fully-resident mip
        self.page_table = np.full(self.n_vtiles, -1, np.int32)
        self.free_pages = list(range(budget_pages))
        self.page_tile = np.full(budget_pages, -1, np.int64)  # page -> vtile
        self.page_touch = np.zeros(budget_pages, np.float64)
        # per (mat) target mip + per-mat last-demand timestamps per mip
        self.desired = self.tail_mip.copy()
        self.last_demand = np.zeros((M, MAX_MIPS), np.float64)
        # partially-loaded mip progress: (mat, mip) -> set of pending tiles
        self._loading: Dict[tuple, set] = {}
        self._pending: Optional[_Upload] = None
        self.tiles_uploaded = 0        # tiles written to the device pool so far
        self._feedback = None
        self._lock = threading.Lock()
        self._stop = False
        self._worker = None
        if not sync_mode:
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _chain(self, mi: int):
        with self._chain_lock:
            if self._chains[mi] is None:
                self._chains[mi] = material_texel_chain(self.scene, mi) or []
            c = self._chains[mi]
        return c if c else None

    def initial_tables(self, device) -> StreamTables:
        """Device tensors at startup on ``device``: tail resident, pool empty."""
        pool = np.zeros((self.pool_base + self.budget_pages * PAGE_TEXELS, 4), np.uint32)
        pool[:self.pool_base] = self.tail_texels

        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)
        return StreamTables(
            tex_pool=t(pool), page_table=t(self.page_table), mat_resident=t(self.resident),
            vt_base=t(self.vt_base), tail_off=t(self.tail_off), pool_base=self.pool_base,
            mat_tex_size=t(self.mat_size))

    # ------------------------------------------------------------------
    def publish_feedback(self, presence):
        """presence: (Mat, MAX_MIPS) device or np array of sample counts
        (the per-frame feedback resolve)."""
        with self._lock:
            self._feedback = presence

    def _consume_feedback(self):
        with self._lock:
            fb = self._feedback
            self._feedback = None
        if fb is None:
            return
        fb = np.asarray(fb)           # already host-side (renderer fetches on
        #                               the main thread; device access is not
        #                               thread-safe through every backend)
        now = self._now()
        seen = fb > 0
        self.last_demand[seen] = now
        for mi in range(self.n_mats):
            mips = np.nonzero(seen[mi])[0]
            want = int(mips.min()) if mips.size else int(self.tail_mip[mi])
            want = min(want, int(self.tail_mip[mi]))
            if want < self.desired[mi]:
                self.desired[mi] = want          # upgrade immediately
            elif want > self.desired[mi]:
                # downgrade only after hysteresis without finer demand
                finer = self.last_demand[mi, :self.desired[mi] + 1].max()
                if now - finer > self.hysteresis_s:
                    self.desired[mi] = want

    # ------------------------------------------------------------------
    def _mip_tiles(self, mi: int, li: int) -> int:
        Sl = max(int(self.mat_size[mi]) >> li, 1)
        return (Sl // TILE) ** 2 if Sl > TAIL_MAX else 0

    def _alloc_page(self, now: float) -> Optional[int]:
        if self.free_pages:
            return self.free_pages.pop()
        # LRU recycle from a tile of a mip that is NOT required by the
        # current desired residency of its material
        victims = np.argsort(self.page_touch)
        for p in victims:
            vt = self.page_tile[p]
            if vt < 0:
                return int(p)
            mi, li = self._vt_owner(int(vt))
            if li < self.desired[mi]:   # finer than any current demand
                self.page_table[vt] = -1
                self.page_tile[p] = -1
                # that mip is no longer complete
                self.resident[mi] = max(self.resident[mi], li + 1)
                # if a partial load of that mip is pending, the evicted tile
                # must rejoin it — otherwise the pend drains without it and
                # the mip is claimed complete with a hole (absent key is
                # fine: the next demand reseeds ALL tiles)
                key = (mi, li)
                if key in self._loading:
                    self._loading[key].add(int(vt) - int(self.vt_base[mi, li]))
                return int(p)
        return None

    def _vt_owner(self, vt: int):
        """(mat, mip) owning a virtual tile id."""
        for mi in range(self.n_mats):
            for li in range(MAX_MIPS):
                b = self.vt_base[mi, li]
                if b < 0 or b > vt:
                    continue
                if vt < b + self._mip_tiles(mi, li):
                    return mi, li
        return 0, 0

    def _schedule(self):
        """One budget's worth of tile loads toward the desired residency.
        Returns an _Upload batch or None."""
        now = self._now()
        rows_l, tex_l, entries = [], [], []
        freed: List[int] = []
        budget = self.tiles_per_frame
        for mi in range(self.n_mats):
            li = int(self.resident[mi]) - 1
            # work toward finer mips one level at a time
            while budget > 0 and int(self.desired[mi]) <= li < MAX_MIPS:
                chain = self._chain(mi)
                if chain is None or li >= len(chain):
                    break
                Sl = chain[li].shape[0]
                tiles_x = Sl // TILE
                key = (mi, li)
                if key not in self._loading:
                    self._loading[key] = set(range(tiles_x * tiles_x))
                pend = self._loading[key]
                done_any = False
                for t in sorted(pend):
                    if budget <= 0:
                        break
                    page = self._alloc_page(now)
                    if page is None:
                        budget = 0
                        break
                    ty, tx = divmod(t, tiles_x)
                    tile = chain[li][ty * TILE:(ty + 1) * TILE,
                                     tx * TILE:(tx + 1) * TILE]
                    texels = (tile.reshape(-1, 4, 4).view(np.uint32)
                              .reshape(-1, 4))
                    vt = int(self.vt_base[mi, li]) + t
                    base = self.pool_base + page * PAGE_TEXELS
                    rows_l.append(np.arange(base, base + PAGE_TEXELS,
                                            dtype=np.int32))
                    tex_l.append(texels)
                    entries.append((vt, page))
                    self.page_table[vt] = page
                    self.page_tile[page] = vt
                    self.page_touch[page] = now
                    pend.discard(t)
                    budget -= 1
                    done_any = True
                if not pend:
                    del self._loading[key]
                    self.resident[mi] = li       # mip complete -> sampleable
                    li -= 1
                elif not done_any:
                    break
                else:
                    break   # budget hit mid-mip; resume next poll
        # hysteresis-driven downgrades: release pages of mips finer than
        # desired once stale
        for mi in range(self.n_mats):
            while self.resident[mi] < self.desired[mi]:
                li = int(self.resident[mi])
                if now - self.last_demand[mi, li] <= self.hysteresis_s:
                    break
                for t in range(self._mip_tiles(mi, li)):
                    vt = int(self.vt_base[mi, li]) + t
                    p = int(self.page_table[vt])
                    if p >= 0:
                        self.page_table[vt] = -1
                        self.page_tile[p] = -1
                        self.free_pages.append(p)
                        freed.append(p)
                self.resident[mi] = li + 1
        if not rows_l and not freed and self._pending is None:
            return None
        if not rows_l and not freed:
            return None
        return _Upload(
            rows=np.concatenate(rows_l) if rows_l else np.zeros(0, np.int32),
            texels=(np.concatenate(tex_l) if tex_l
                    else np.zeros((0, 4), np.uint32)),
            page_entries=np.asarray(entries, np.int32).reshape(-1, 2),
            resident=self.resident.copy(), freed=freed)

    # ------------------------------------------------------------------
    def _worker_loop(self):
        while not self._stop:
            self._consume_feedback()
            with self._lock:
                have = self._pending is not None
            if not have:
                up = self._schedule()
                if up is not None:
                    with self._lock:
                        self._pending = up
            time.sleep(0.005)

    def poll(self):
        """Synchronous step (tests / sync_mode): consume feedback, schedule."""
        self._consume_feedback()
        up = self._schedule()
        if up is not None:
            self._pending = up

    def apply_updates(self, tables: StreamTables) -> StreamTables:
        """Apply a finished upload batch (call from the frame loop, on the
        thread that renders): the batch's pool rows and page-table entries
        are written in place on the tables' device, through pinned memory
        without waiting for the device (scene/gpu.py::_upload)."""
        with self._lock:
            up = self._pending
            self._pending = None
            # frees were recorded in the host mirror by _schedule; at most
            # one batch is ever outstanding, so the mirror is authoritative
            # here. Copied while the batch is still pending: the worker
            # schedules (and edits the mirror) only once it is taken.
            full_pt = self.page_table.copy() if up is not None and up.freed else None
        if up is None:
            return tables
        self.tiles_uploaded += int(up.page_entries.shape[0])
        from hobbyrenderer_tpu_torch.scene.gpu import _upload
        dev = tables.tex_pool.device
        pool, pt = tables.tex_pool, tables.page_table
        if up.rows.size:
            # uint32 words travel as int32 bits, widened on the device
            words = _upload(up.texels.view(np.int32), dev).to(torch.int64) & 0xFFFFFFFF
            pool[_upload(up.rows, dev).to(torch.int64)] = words
        if up.page_entries.size:
            e = _upload(up.page_entries, dev).to(torch.int64)
            pt[e[:, 0]] = e[:, 1]
        if full_pt is not None:
            pt = _upload(full_pt, dev).to(torch.int64)
        return tables._replace(tex_pool=pool, page_table=pt,
                               mat_resident=_upload(up.resident, dev).to(torch.int64))

    def stop(self):
        self._stop = True
        if self._worker is not None:
            self._worker.join(timeout=1.0)
