"""Speculative multi-token decode: proposers and configuration.

A *proposer* guesses k draft tokens per active row; the engine then runs
the target model once at query width k+1 (the ``(tier, k)`` pair is just
another shape bucket of the canonical decode lowering, replayed as one
CUDA Graph on the card) and accepts the longest draft prefix that
matches what the target itself would have emitted, plus one corrected
token.  Greedy speculative decode is
bitwise identical to plain greedy decode; sampled speculative decode is
lossless too because sampling keys are position-derived
(``serve.sampling``), so the verify step re-samples each position with
exactly the key plain decode would have used.

Two built-in proposers:

* :class:`NGramProposer` — host-side prompt-lookup drafting.  Finds the
  most recent earlier occurrence of the stream's trailing n-gram and
  proposes its continuation.  Zero extra device FLOPs; strong on
  repetitive/structured continuations (code, retrieval, summaries).
* :class:`SelfSpecProposer` — self-speculative drafting: re-runs the
  first ``n_layers`` of the *same* model (truncated-layer reuse of the
  same params and KV cache) k times at width 1.  The layer loop runs the
  first ``n_layers`` layers over the already-lowered per-layer decode
  plan (``Forward(..., depth=n)``) — no new lowerings.

Custom proposers implement the :class:`Proposer` protocol: host-side
ones override :meth:`Proposer.draft`; device-side ones set
``device = True`` and the engine builds the draft step from the model
(see ``ServeEngine._spec_draft_run``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from .sampling import SamplingConfig

#: draft-k candidates registered as the ``spec_decode`` tunable
#: param_space in the strategy registry (``core.strategies.registry``);
#: ``SpecConfig(k="auto")`` picks among these from measured acceptance.
DRAFT_K_CANDIDATES = (2, 4, 8)


class Proposer:
    """Draft-token source for speculative decode.

    Host proposers implement :meth:`draft`; device proposers set
    ``device = True`` (drafts are then produced inside the captured
    step and never leave the device).
    """

    name = "proposer"
    device = False

    def draft(self, streams: Sequence[Sequence[int]], k: int) -> np.ndarray:
        """(len(streams), k) int32 draft tokens; ``streams[i]`` is row
        i's full token stream so far (prompt + generated)."""
        raise NotImplementedError

    def identity(self) -> tuple:
        return (self.name,)


class NGramProposer(Proposer):
    """Prompt-lookup drafting (host-side, zero device FLOPs).

    For each row, scan for the most recent earlier occurrence of the
    stream's trailing n-gram (longest first, ``max_ngram`` down to
    ``min_ngram``) and draft its continuation; fall back to repeating
    the last token when nothing matches.
    """

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError("NGramProposer: need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def identity(self) -> tuple:
        return (self.name, self.max_ngram, self.min_ngram)

    def draft(self, streams, k):
        out = np.empty((len(streams), k), np.int32)
        for i, stream in enumerate(streams):
            out[i] = self._draft_one(np.asarray(stream, np.int32), k)
        return out

    def _draft_one(self, stream: np.ndarray, k: int) -> np.ndarray:
        n = len(stream)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = stream[n - g:]
            # most recent earlier occurrence wins (locality: recent
            # continuations predict the next tokens best)
            windows = np.lib.stride_tricks.sliding_window_view(
                stream[:n - 1], g)
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + g
            cont = stream[start:start + k]
            if cont.size == 0:
                continue
            if cont.size < k:
                cont = np.concatenate(
                    [cont, np.full(k - cont.size, cont[-1], np.int32)])
            return cont
        return np.full(k, stream[-1] if n else 0, np.int32)


class SelfSpecProposer(Proposer):
    """Self-speculative drafting: the first ``n_layers`` of the target
    model act as the draft model (same params, same KV cache; the draft
    writes its K/V at the positions the verify step then rewrites).
    ``n_layers=None`` defaults to half the stack.  Requires a model
    whose decode phase is a single layer stack (e.g. the dense
    transformer family).
    """

    name = "selfspec"
    device = True

    def __init__(self, n_layers: Optional[int] = None):
        if n_layers is not None and n_layers < 1:
            raise ValueError("SelfSpecProposer: n_layers must be >= 1")
        self.n_layers = n_layers

    def identity(self) -> tuple:
        return (self.name, self.n_layers)


def resolve_proposer(proposer: Union[str, Proposer]) -> Proposer:
    if isinstance(proposer, Proposer):
        return proposer
    if proposer == "ngram":
        return NGramProposer()
    if proposer in ("self", "selfspec"):
        return SelfSpecProposer()
    raise ValueError(
        f"unknown proposer {proposer!r}: expected 'ngram', 'self', or a "
        "Proposer instance")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs for ``ServeConfig(spec=...)``.

    ``proposer``: ``"ngram"``, ``"self"``, or a :class:`Proposer`.
    ``k``: draft tokens per verify step (>= 1), or ``"auto"`` to pick
    per context from the registered ``spec_decode`` param_space using
    acceptance rates fed through ``AutoPolicy.observe``.
    ``sampling``: overrides the engine-wide sampling policy for decode.
    """

    proposer: Union[str, Proposer] = "ngram"
    k: Union[int, str] = 4
    sampling: Optional[SamplingConfig] = None

    def __post_init__(self):
        if self.k != "auto" and (not isinstance(self.k, int) or self.k < 1):
            raise ValueError("SpecConfig: k must be an int >= 1 or 'auto'")
        resolve_proposer(self.proposer)  # fail fast on typos
