"""The plan-aware overlap model the autotuner ranks candidates with.
The dry run's HLO roofline (``hlo.py``, ``model.py`` in the JAX package)
waits for the port of ``launch/dryrun.py``."""
from .overlap import OverlapReport, plan_overlap, split_weight_penalty  # noqa: F401
