"""Dense KV cache: one ``s_max`` row per admitted request.

The cache tensors are preallocated once on the device, stacked
``(n_layers, max_batch, s_max, kv, hd)``; prefill KV is copied into a
request's row in place and decode updates it in place.  The manager
keeps the row lifecycle on the host: ``free_rows`` (sorted),
``row_owner`` (row -> request id), the ``lengths`` mirror, and typed
:class:`CacheRowError` on a double release or a bad ``move_row``.
Allocation returns ``None`` on an empty pool — an admission signal, not
an error — and the engine may deny it further (a pressure window or the
fault injector, ``ServeEngine._try_allocate``).  ``free_tokens`` /
``token_capacity`` are the admission context's capacity signals,
row-granular here.  The paged cache arrives with a later slice.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


class CacheRowError(RuntimeError):
    """Row bookkeeping violation: double release, releasing a row that
    was never allocated, or an invalid ``move_row``.  These are engine
    bugs (or deliberate chaos probes), never load conditions: a leaked
    or doubly freed row would corrupt a later request's cache."""


@dataclasses.dataclass(frozen=True)
class DenseCache:
    """The dense backend: whole rows reserved up front."""

    name = "dense"

    def identity(self) -> tuple:
        """What salts the PlanStore keys of the steps built over it."""
        return ("dense",)

    def build(self, model, cfg, device) -> "KVCacheManager":
        return KVCacheManager(model, cfg.max_batch, cfg.s_max, device)


class KVCacheManager:
    """Dense per-slot pool: requests own whole rows."""

    paged = False

    def __init__(self, model, max_batch: int, s_max: int, device=None):
        device = resolve_device(device)
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
        if src == dst:
            raise CacheRowError(f"move_row src == dst == {src}")
        if src not in self.row_owner:
            raise CacheRowError(
                f"move_row src {src} is not an active row "
                f"(active: {sorted(self.row_owner)})")
        if dst not in self.free_rows:
            raise CacheRowError(f"move_row dst {dst} is not free "
                                f"(free: {self.free_rows})")
        for k, c in self.caches.items():
            bd = self.batch_dims[k]
            c.select(bd, dst).copy_(c.select(bd, src))
        self.lengths[dst] = self.lengths[src]
        self.lengths[src] = 0
        self.row_owner[dst] = self.row_owner.pop(src)
        self.free_rows.remove(dst)
        bisect.insort(self.free_rows, src)

    # -- capacity (the admission context's signals) -----------------------
    def token_capacity(self) -> int:
        return self.max_batch * self.s_max

    def free_tokens(self) -> int:
        """Token capacity still allocatable (admission pressure signal)."""
        return len(self.free_rows) * self.s_max

    def resident_tokens(self) -> int:
        return int(self.lengths.sum())

    def kv_stats(self) -> dict:
        return {"backend": DenseCache.name,
                "capacity_tokens": self.token_capacity(),
                "free_tokens": self.free_tokens(),
                "resident_tokens": self.resident_tokens()}
