"""Three-term roofline model over a dry run's counts (the port of
``src/repro/roofline/model.py``).

    compute    = FLOPs / peak_FLOP/s
    memory     = HBM bytes / HBM_bw
    collective = wire_bytes / (links · link_bw)

The counts are one rank's (``roofline/count.py`` runs rank 0's step on
the ``meta`` device), so no term divides by the chip count.  The field
names ``hlo_flops`` and ``hlo_bytes`` are the JAX package's, so records
from either package read alike; in the port they are counted from the
aten ops the step dispatches and the kernels it launches, not read from
XLA's HLO.  Collective wire bytes come from the per-rank payloads with
ring-efficiency factors (payload P on an N-ring: all-reduce moves
2P(N-1)/N per link-step chain, reduce-scatter/all-gather P(N-1)/N,
all-to-all P(N-1)/N split across opposing directions,
collective-permute P).

The terms read ``hw.py``'s H100 datasheet figures: ``PEAK_FLOPS_BF16``,
``HBM_BW``, and ``NVLINK_LINKS · NVLINK_BW_PER_LINK`` where the JAX
package reads its ICI links.  Known gap: an H100 host joins 8 cards by
NVLink, so a 16-wide ``model`` axis spans two NVLink domains and half
its ring crosses the slower network between hosts; the collective term
charges NVLink for every axis, as the JAX package charges ICI for every
axis of its torus.

Also reports MODEL_FLOPS = 6·N·D (train) or 2·N·D (serve), N the active
parameters, and the useful-compute ratio MODEL_FLOPS / chips / FLOPs.
"""
from __future__ import annotations

import dataclasses

from .. import hw

RING_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 0.25,        # bidirectional ring halves each direction
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_payload: dict                  # kind -> bytes (per chip, payload)
    model_flops: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_ratio: float
    notes: str = ""

    @property
    def t_total_seq(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def t_bound(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_total_seq=self.t_total_seq, t_bound=self.t_bound)
        return d


def wire_bytes(coll_payload: dict, axis_size: int = 16) -> float:
    total = 0.0
    for kind, nbytes in coll_payload.items():
        if kind == "total":
            continue
        eff = RING_FACTOR.get(kind, 1.0) * (axis_size - 1) / max(axis_size, 1)
        total += nbytes * eff
    return total


def roofline_terms(*, arch: str, shape: str, mesh: str, chips: int,
                   hlo_flops: float, hlo_bytes: float, coll_payload: dict,
                   n_params: float, n_active: float, tokens: float,
                   train: bool, axis_size: int = 16,
                   notes: str = "") -> RooflineResult:
    # the counts are already one rank's (the dry run runs rank 0's step)
    t_compute = hlo_flops / hw.PEAK_FLOPS_BF16
    t_memory = hlo_bytes / hw.HBM_BW
    wire = wire_bytes(coll_payload, axis_size)
    t_coll = wire / (hw.NVLINK_LINKS * hw.NVLINK_BW_PER_LINK)
    mult = 3.0 if train else 1.0       # fwd+bwd ≈ 3x fwd matmul flops
    model_flops = 2.0 * n_active * tokens * mult
    useful = (model_flops / chips) / max(hlo_flops, 1.0)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    bott = max(terms, key=terms.get)
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        coll_payload=coll_payload, model_flops=model_flops,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
        bottleneck=bott, useful_ratio=useful, notes=notes)
