"""Dense KV cache: one ``s_max`` row per admitted request.

The cache tensors are preallocated once on the device, stacked
``(n_layers, max_batch, s_max, kv, hd)``; prefill KV is copied into a
request's row in place and decode updates it in place.  The paged cache
arrives with a later slice.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


class CacheRowError(RuntimeError):
    """An invalid row operation (double release, moving a free row)."""


@dataclasses.dataclass(frozen=True)
class DenseCache:
    """The dense backend: whole rows reserved up front."""

    name = "dense"

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
                f"(active rows: {sorted(self.row_owner)})")
        self.row_owner.pop(row)
        self.lengths[row] = 0
        bisect.insort(self.free_rows, row)

    def move_row(self, src: int, dst: int):
        """Relocate a request's cache rows ``src -> dst`` (tier-shrink
        compaction): one in-place row copy per cache tensor, ordered on
        the stream behind any step still in flight."""
        if src == dst or src not in self.row_owner \
                or dst not in self.free_rows:
            raise CacheRowError(f"bad move_row {src} -> {dst}")
        for k, c in self.caches.items():
            bd = self.batch_dims[k]
            c.select(bd, dst).copy_(c.select(bd, src))
        self.lengths[dst] = self.lengths[src]
        self.lengths[src] = 0
        self.row_owner[dst] = self.row_owner.pop(src)
        self.free_rows.remove(dst)
        bisect.insort(self.free_rows, src)
