"""Pricing plans and steps on the H100: the plan-aware overlap model the
autotuner ranks candidates with (``overlap.py``), the dry run's counter
of a step's work on the ``meta`` device (``count.py``, the counterpart of
the JAX package's ``roofline/hlo.py``) and its three-term roofline
(``model.py``)."""
from .count import analyze  # noqa: F401
from .model import RooflineResult, roofline_terms, wire_bytes  # noqa: F401
from .overlap import OverlapReport, plan_overlap, split_weight_penalty  # noqa: F401
