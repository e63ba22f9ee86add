"""KV-cache storage backends for the serving engine.

The memory layout is a pluggable policy: a :class:`CacheBackend` is a
frozen dataclass with a stable ``identity()`` whose ``build()`` makes
the engine's cache manager.  Two backends ship:

  * :class:`DenseCache` (the default): one ``s_max`` row per admitted
    request, preallocated once on the device, stacked ``(n_layers,
    max_batch, s_max, kv, hd)``; prefill KV is copied into a request's
    row in place and decode updates it in place.
  * :class:`PagedCache`: a shared pool of fixed-size pages per cache
    tensor plus a page table per request row.  KV memory scales with the
    tokens resident, admission is page capacity rather than row count,
    and tier-shrink compaction hands a page-table row over instead of
    copying cache rows on the device.

Both managers keep the row lifecycle on the host: ``free_rows``
(sorted), ``row_owner`` (row -> request id), the ``lengths`` mirror of
each row's occupancy, and a typed :class:`CacheRowError` on a double
release or a bad ``move_row``.  Allocation returns ``None`` on an empty
pool and ``reserve`` returns False on an exhausted page pool — admission
signals, not errors.  ``free_tokens`` / ``token_capacity`` are the
admission context's capacity signals: row-granular on the dense
backend, page-granular on the paged one.

The backend's ``identity()`` salts every PlanStore key the engine forms
(the plans' outer keys through the op-closure config, the graphs' keys
through :func:`cache_backend_salt`), so dense and paged steps coexist in
one store and restore independently.

Paged layout.  Physical page 0 is a **trash page**: the page-table
entries of unallocated blocks point at it, so a captured step may write
through them unconditionally (a bucket's padding past a short prompt,
the frontier write of a row that is mid chunked prefill, the rows of a
tier prefix that hold no request) without corrupting a later owner.
Real pages are ``1..num_pages``.  The device helpers gather a tier's
pages into the contiguous ``(tier, s_max, ...)`` view the model's decode
forward reads, and scatter back only the pages a step wrote, with
``index_select`` and in-place ``index_copy_`` on the pool and no host
read of a device value, so that they run inside a CUDA Graph.
``index_copy_`` leaves the winner of a repeated index undefined on CUDA,
so only the trash page may repeat within one call; a real page appears
at most once (the engine checks the page table it stages).
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import heapq
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


class CacheRowError(RuntimeError):
    """Row bookkeeping violation: double release, releasing a row that
    was never allocated, or an invalid ``move_row``.  These are engine
    bugs (or deliberate chaos probes), never load conditions: a leaked
    or doubly freed row would corrupt a later request's cache."""


class UnpageableCache(ValueError):
    """The model's decode state has no sequence axis to page over (SSM
    conv/state tensors); serve it with :class:`DenseCache`."""


# -- backend protocol --------------------------------------------------------


class CacheBackend:
    """Protocol base: frozen dataclasses with a stable ``identity()`` (a
    tuple of primitives, the same in every process — it salts PlanStore
    keys) and a ``build(model, cfg, device)`` making the engine's cache
    manager."""

    name = "cache"

    def identity(self) -> tuple:
        raise NotImplementedError

    def build(self, model, cfg, device=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseCache(CacheBackend):
    """The default: one ``s_max`` row per admitted request, reserved up
    front."""

    name = "dense"

    def identity(self) -> tuple:
        return ("dense",)

    def build(self, model, cfg, device=None) -> "KVCacheManager":
        return KVCacheManager(model, cfg.max_batch, cfg.s_max, device,
                              backend=self)


@dataclasses.dataclass(frozen=True)
class PagedCache(CacheBackend):
    """Paged KV: a shared pool of ``num_pages`` pages of ``page_size``
    tokens per cache tensor, allocated to requests on demand.

    ``num_pages=None`` sizes the pool to the dense equivalent
    (``max_batch * s_max / page_size`` pages: the same bytes, but memory
    scales with the tokens resident, so the pool admits more concurrent
    requests wherever lengths run short of ``s_max``).  ``page_size``
    must divide ``s_max`` and every prefill bucket (chunk offsets are
    bucket sums, so every cache write is whole pages)."""

    page_size: int = 16
    num_pages: Optional[int] = None
    name = "paged"

    def identity(self) -> tuple:
        return ("paged", self.page_size, self.num_pages)

    def build(self, model, cfg, device=None) -> "PagedKVCacheManager":
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1: {self.page_size}")
        if cfg.s_max % self.page_size:
            raise ValueError(
                f"page_size {self.page_size} must divide s_max "
                f"{cfg.s_max}")
        bad = [b for b in cfg.prefill_buckets if b % self.page_size]
        if bad:
            raise ValueError(
                f"page_size {self.page_size} must divide every prefill "
                f"bucket (chunk offsets are bucket sums and cache writes "
                f"are page-granular); offending buckets: {bad}")
        return PagedKVCacheManager(model, cfg.max_batch, cfg.s_max,
                                   backend=self, device=device)


def resolve_cache_backend(cache) -> CacheBackend:
    """Normalize ``ServeConfig.cache``: ``None`` -> :class:`DenseCache`,
    the names ``"dense"`` / ``"paged"`` -> default instances, a backend
    passes through."""
    if cache is None:
        return DenseCache()
    if isinstance(cache, str):
        if cache == "dense":
            return DenseCache()
        if cache == "paged":
            return PagedCache()
        raise ValueError(f"unknown cache backend {cache!r} "
                         "(expected 'dense', 'paged', or a CacheBackend)")
    if isinstance(cache, CacheBackend):
        return cache
    raise TypeError(f"cache must be a CacheBackend, a name, or None; "
                    f"got {type(cache).__name__}")


def backend_from_identity(ident) -> CacheBackend:
    """Rebuild a backend from its ``identity()`` tuple — the inverse a
    ``Program.save`` / ``load`` bundle needs (identities are primitives,
    so they round-trip through JSON)."""
    ident = tuple(ident)
    if ident[:1] == ("dense",):
        return DenseCache()
    if ident[:1] == ("paged",) and len(ident) == 3:
        return PagedCache(
            page_size=int(ident[1]),
            num_pages=None if ident[2] is None else int(ident[2]))
    raise ValueError(f"unknown cache backend identity {ident!r}")


def cache_backend_salt(backend: CacheBackend) -> str:
    """The backend's identity as a short printable salt for the engine's
    graph keys (the ``core.plan.strategy_salt`` idiom)."""
    digest = hashlib.sha256(
        repr(backend.identity()).encode()).hexdigest()[:12]
    return f"{backend.name}:{digest}"


# -- dense -------------------------------------------------------------------


class KVCacheManager:
    """Dense per-slot pool: requests own whole rows."""

    paged = False

    def __init__(self, model, max_batch: int, s_max: int, device=None,
                 backend: Optional[CacheBackend] = None):
        device = resolve_device(device)
        self.backend = backend or DenseCache()
        self.max_batch = max_batch
        self.s_max = s_max
        self.caches = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                       for k, v in model.decode_cache_env(
                           max_batch, s_max).items()}
        layout = model.decode_cache_layout()
        # which dim of each cache tensor is the request-batch dim (0 for
        # per-layer tensors, 1 for (L, B, ...) stacked caches)
        self.batch_dims = {k: layout[k][0] for k in self.caches}
        self.lengths = np.zeros((max_batch,), np.int32)
        self.free_rows = list(range(max_batch))
        self.row_owner: dict[int, int] = {}    # row -> request id

    # -- rows -------------------------------------------------------------
    def allocate(self, request_id: int) -> Optional[int]:
        if not self.free_rows:
            return None
        row = self.free_rows.pop(0)
        self.row_owner[row] = request_id
        self.lengths[row] = 0
        return row

    def release(self, row: int):
        if row not in self.row_owner:
            raise CacheRowError(
                f"release of row {row} which is not allocated "
                f"(double release or unknown row; active rows: "
                f"{sorted(self.row_owner)})")
        self.row_owner.pop(row)
        self.lengths[row] = 0
        bisect.insort(self.free_rows, row)

    def move_row(self, src: int, dst: int):
        """Relocate a request's cache rows ``src -> dst`` (tier-shrink
        compaction): one in-place row copy per cache tensor, ordered on
        the stream behind any step still in flight."""
        self._check_move(src, dst)
        for k, c in self.caches.items():
            bd = self.batch_dims[k]
            c.select(bd, dst).copy_(c.select(bd, src))
        self._move_bookkeeping(src, dst)

    def _check_move(self, src: int, dst: int):
        if src == dst:
            raise CacheRowError(f"move_row src == dst == {src}")
        if src not in self.row_owner:
            raise CacheRowError(
                f"move_row src {src} is not an active row "
                f"(active: {sorted(self.row_owner)})")
        if dst not in self.free_rows:
            raise CacheRowError(f"move_row dst {dst} is not free "
                                f"(free: {self.free_rows})")

    def _move_bookkeeping(self, src: int, dst: int):
        self.lengths[dst] = self.lengths[src]
        self.lengths[src] = 0
        self.row_owner[dst] = self.row_owner.pop(src)
        self.free_rows.remove(dst)
        bisect.insort(self.free_rows, src)

    # -- capacity (the admission context's signals) -----------------------
    def reserve(self, row: int, new_len: int) -> bool:
        """Ensure the row can hold ``new_len`` tokens.  A dense row owns
        a whole ``s_max`` slice from allocation on: always True."""
        return True

    def rollback(self, row: int, new_len: int) -> int:
        """Release storage beyond ``new_len`` tokens (a rejected
        speculative draft).  The length mirror is what masks positions
        past a row's occupancy, so on the dense backend this frees
        nothing: returns 0 pages."""
        return 0

    def token_capacity(self) -> int:
        return self.max_batch * self.s_max

    def free_tokens(self) -> int:
        """Token capacity still allocatable (admission pressure signal)."""
        return len(self.free_rows) * self.s_max

    def resident_tokens(self) -> int:
        return int(self.lengths.sum())

    def kv_stats(self) -> dict:
        return {"backend": self.backend.name,
                "capacity_tokens": self.token_capacity(),
                "free_tokens": self.free_tokens(),
                "resident_tokens": self.resident_tokens()}


# -- paged -------------------------------------------------------------------


class PagedKVCacheManager(KVCacheManager):
    """Paged pool: requests own page-table rows mapping logical blocks to
    physical pages, allocated on demand as a sequence grows.

    The pool tensors replace the dense batch dim with a physical-page dim
    and shrink the sequence dim to one page (``(P+1, page, kv, hd)`` per
    layer, ``(L, P+1, page, kv, hd)`` stacked, from the model's
    ``decode_cache_page_env``).  A step gathers a tier's pages into the
    ``(tier, s_max, ...)`` view the decode forward expects, so the
    forward and its plans are those of the dense backend, and scatters
    back only the pages it wrote."""

    paged = True

    def __init__(self, model, max_batch: int, s_max: int,
                 backend: PagedCache, device=None):
        device = resolve_device(device)
        self.backend = backend
        self.max_batch = max_batch
        self.s_max = s_max
        self.page_size = backend.page_size
        self.blocks_per_row = s_max // self.page_size
        self.num_pages = (backend.num_pages
                          if backend.num_pages is not None
                          else max_batch * self.blocks_per_row)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1: {self.num_pages}")
        # +1: physical page 0 is the trash page (never allocated)
        env = model.decode_cache_page_env(self.num_pages + 1,
                                          self.page_size)
        self.caches = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                       for k, v in env.items()}
        layout = model.decode_cache_layout()
        self.batch_dims = {k: layout[k][0] for k in self.caches}
        self.lengths = np.zeros((max_batch,), np.int32)
        self.free_rows = list(range(max_batch))
        self.row_owner: dict[int, int] = {}
        # logical block -> physical page; 0 = trash (unmapped)
        self.page_table = np.zeros((max_batch, self.blocks_per_row),
                                   np.int32)
        self.blocks_used = np.zeros((max_batch,), np.int32)
        self.free_pages = list(range(1, self.num_pages + 1))
        heapq.heapify(self.free_pages)
        self.peak_pages_used = 0

    # -- pages ------------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.page_size)

    def pages_used(self) -> int:
        return self.num_pages - len(self.free_pages)

    def reserve(self, row: int, new_len: int) -> bool:
        """Ensure the row's page table covers ``new_len`` tokens, taking
        pages from the shared pool on demand.  Returns False when the
        pool is exhausted (nothing taken) — an admission or preemption
        signal, never an exception."""
        if row not in self.row_owner:
            raise CacheRowError(
                f"reserve on row {row} which is not allocated")
        if new_len > self.s_max:
            return False
        need = self.pages_needed(new_len)
        cur = int(self.blocks_used[row])
        if need <= cur:
            return True
        if need - cur > len(self.free_pages):
            return False
        for blk in range(cur, need):
            self.page_table[row, blk] = heapq.heappop(self.free_pages)
        self.blocks_used[row] = need
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used())
        return True

    def rollback(self, row: int, new_len: int) -> int:
        """Free the pages reserved past ``new_len`` tokens (the pages a
        verify step reserved for rejected draft positions: they hold only
        garbage, so a later owner may take them).  Returns the number of
        pages freed."""
        if row not in self.row_owner:
            raise CacheRowError(
                f"rollback on row {row} which is not allocated")
        need = self.pages_needed(new_len)
        cur = int(self.blocks_used[row])
        for blk in range(need, cur):
            heapq.heappush(self.free_pages, int(self.page_table[row, blk]))
            self.page_table[row, blk] = 0
        if need < cur:
            self.blocks_used[row] = need
        return max(0, cur - need)

    def release(self, row: int):
        if row not in self.row_owner:
            raise CacheRowError(
                f"release of row {row} which is not allocated "
                f"(double release or unknown row; active rows: "
                f"{sorted(self.row_owner)})")
        self.row_owner.pop(row)
        self.lengths[row] = 0
        for blk in range(int(self.blocks_used[row])):
            heapq.heappush(self.free_pages, int(self.page_table[row, blk]))
        self.page_table[row, :] = 0
        self.blocks_used[row] = 0
        bisect.insort(self.free_rows, row)

    def move_row(self, src: int, dst: int):
        """Tier-shrink compaction by page-table handoff: the physical
        pages stay where they are; only the host-side row bookkeeping
        moves.  No device copy."""
        self._check_move(src, dst)
        self.page_table[dst, :] = self.page_table[src, :]
        self.page_table[src, :] = 0
        self.blocks_used[dst] = self.blocks_used[src]
        self.blocks_used[src] = 0
        self._move_bookkeeping(src, dst)

    def check_unaliased(self, rows) -> None:
        """Raise :class:`CacheRowError` if a real page is mapped twice
        among the page-table ``rows`` (a step's ``index_copy_`` would
        then write it twice with no defined winner)."""
        pages = rows[rows > 0]
        if len(np.unique(pages)) != len(pages):
            raise CacheRowError(
                "a physical page is mapped by two blocks of one step: "
                f"{np.sort(pages).tolist()}")

    # -- capacity ---------------------------------------------------------
    def token_capacity(self) -> int:
        return self.num_pages * self.page_size

    def free_tokens(self) -> int:
        return len(self.free_pages) * self.page_size

    def kv_stats(self) -> dict:
        out = super().kv_stats()
        out.update(page_size=self.page_size, num_pages=self.num_pages,
                   pages_used=self.pages_used(),
                   peak_pages_used=self.peak_pages_used,
                   kv_util=(self.peak_pages_used * self.page_size
                            / max(1, self.token_capacity())))
        return out

    # -- device helpers (run inside the captured steps) -------------------
    def _blocks(self, k: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` — a view ``(n, S, ...)`` of cache ``k``, stacked ``(L, n,
        S, ...)`` — as its ``n * S / page`` page-sized blocks along the
        batch dim (row ``i``'s block ``b`` at ``i * S / page + b``)."""
        bd = self.batch_dims[k]
        shape = t.shape
        return t.reshape(shape[:bd] + (shape[bd] * (shape[bd + 1]
                                                    // self.page_size),
                                       self.page_size) + shape[bd + 2:])

    def gather_rows(self, caches: dict, page_tab: torch.Tensor,
                    tier: int) -> dict:
        """Gather the first ``tier`` rows' pages into the contiguous
        ``(tier, s_max, ...)`` view the decode forward expects (the dense
        tier slice's shape, so the decode steps and their plans are the
        dense backend's)."""
        return self.gather_row_batch(caches, page_tab[:tier])

    def gather_row_batch(self, caches: dict,
                         page_rows: torch.Tensor) -> dict:
        """Gather the rows whose page-table rows are ``page_rows``
        ``(b, blocks_per_row)`` into their ``(b, s_max, ...)`` views (the
        chunked prefill's gather)."""
        b = page_rows.shape[0]
        flat = page_rows.reshape(-1).long()
        out = {}
        for k, pool in caches.items():
            bd = self.batch_dims[k]
            g = pool.index_select(bd, flat)
            out[k] = g.reshape(pool.shape[:bd] + (b, self.s_max)
                               + pool.shape[bd + 2:])
        return out

    def _scatter(self, caches: dict, out: dict, src_blocks: torch.Tensor,
                 phys: torch.Tensor):
        """``pool[phys[i]] = block src_blocks[i]`` of the view ``out[k]``
        (:meth:`_blocks`), for every cache."""
        for k, pool in caches.items():
            bd = self.batch_dims[k]
            slab = self._blocks(k, out[k]).index_select(bd, src_blocks)
            pool.index_copy_(bd, phys, slab.to(pool.dtype))

    def scatter_frontier(self, caches: dict, out: dict,
                         page_tab: torch.Tensor, cache_len: torch.Tensor,
                         tier: int):
        """Write back only the frontier page of each of the ``tier`` rows
        — the one block a decode step wrote (position ``cache_len``).
        Rows whose frontier block is unmapped (rows mid chunked prefill
        past their pages, rows of the tier prefix with no request) write
        the trash page."""
        self.scatter_span(caches, out, page_tab, cache_len, tier, 1)

    def scatter_span(self, caches: dict, out: dict, page_tab: torch.Tensor,
                     cache_len: torch.Tensor, tier: int, width: int):
        """Write back every block a step of query width ``width`` may
        have written: positions ``[cache_len, cache_len + width)`` of
        each row (:meth:`scatter_frontier` is ``width == 1``).  Whole
        blocks are written; a block's positions outside the window carry
        what the gather read, so rewriting them changes nothing.  Blocks
        past a row's mapped range, or past ``blocks_per_row``, land in
        the trash page."""
        ps, bpr = self.page_size, self.blocks_per_row
        nb = min(bpr, (width + ps - 2) // ps + 1)
        clen = cache_len[:tier].long()
        blk = (clen[:, None] // ps
               + torch.arange(nb, device=clen.device)[None])   # (t, nb)
        safe = blk.clamp(max=bpr - 1)
        phys = torch.where(blk < bpr,
                           page_tab[:tier].long().gather(1, safe),
                           torch.zeros_like(safe)).reshape(-1)
        rows = torch.arange(tier, device=clen.device)[:, None] * bpr
        self._scatter(caches, out, (rows + safe).reshape(-1), phys)

    def scatter_row_pages(self, caches: dict, out: dict,
                          page_row: torch.Tensor, first_block,
                          n_blocks: int, row: int = 0):
        """Write blocks ``[first_block, first_block + n_blocks)`` of row
        ``row`` of ``out[k]`` — a view ``(n, S, ...)`` (stacked ``(L, n,
        S, ...)``), ``S`` a multiple of the page size — into the pages
        ``page_row`` maps them to.  ``first_block`` may be a device
        tensor of one element (a chunk's offset over the page size);
        unmapped blocks land in the trash page."""
        dev = page_row.device
        blocks = (first_block
                  + torch.arange(n_blocks, device=dev)).reshape(-1).long()
        k = next(iter(caches))
        bd = self.batch_dims[k]
        per_row = out[k].shape[bd + 1] // self.page_size
        self._scatter(caches, out, row * per_row + blocks,
                      page_row.long().index_select(0, blocks))
