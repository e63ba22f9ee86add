"""Persistent PlanStore format — canonical lowerings as on-disk artifacts.

The PlanStore amortizes lowering cost *within* a process; this module
makes the artifact outlive it.  A lowered plan is mostly pure data —
instruction tuples, slot maps, liveness, interned param paths, merge-pad
metadata — plus what must never touch disk: the op callables
(``Instr.fn`` / ``PlanStep.replace_fn``).  We therefore serialize a
**skeleton**: everything ``specialize()`` relies on, with callables
dropped.  ``rehydrate()`` rebinds them from the caller's live
``(graph, plan)`` at load time — which is safe exactly when the
fingerprint-v2 outer key matches, because that key covers the structural
identity *and* the op-closure config the callables were traced with.
CUDA Graphs of whole steps are never persisted: they bind one engine's
buffers and are captured anew in each process.

The format is the JAX package's, byte for byte on the same plans.  A
merge-buffer write carries the buffer's dtype where the JAX package
carries its ``lax.pad`` zero; the port's instruction holds the batch
axis there instead, and ``rehydrate`` re-derives it from the graph.
Dtypes are written by their bare name (``torch.bfloat16`` ->
``"bfloat16"``, as numpy names them).

File format (text, line-oriented, deterministic):

  line 1   JSON header::

      {"magic": "dynaflow-planstore", "format_version": F,
       "fingerprint_version": 2, "entries": N, "one_shot": [...]}

  lines 2+ one outer entry per line::

      E <format_version> <fp2-digest> <sha256[:16] of payload> <payload>

  ``payload`` is compact JSON over a pure-primitive dict (str, int,
  float, bool, None, with tuples as arrays and bytes as
  ``{"__bytes__": base64}`` tags) — no pickle, no code execution, and
  C-speed parsing on the restore path (``ast.literal_eval`` measured
  ~30x slower on real entries, which would eat the warm-start win).
  Entries are addressed by the fingerprint-v2 *digest*; one payload
  holds the salt cross-check, the bucket-invariant analysis, and the
  persisted shape bucket records (the canonical lowering — derived
  buckets are re-specialized, not stored).

Guarantees:

  * **atomicity** — ``write_store`` writes a tempfile in the target
    directory and ``os.replace``s it over the destination; readers
    never observe a torn file,
  * **determinism** — entries and buckets are emitted in sorted-digest
    order with no timestamps, so identical stores produce identical
    bytes (CI can cache on content),
  * **graceful rejection** — a corrupt or version-mismatched header
    fails the whole load (``RestoreError``); a corrupt entry line fails
    only that entry.  Callers fall back to a cold ``lower`` either way.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import tempfile
from typing import Iterable, Optional

import numpy as np

from .analysis import AnalysisResult
from .lowering import Instr, LoweredPlan
from .plan import dtype_name

MAGIC = "dynaflow-planstore"
FORMAT_VERSION = 1
# Version of the "V" (tuning verdict) record schema.  Independent of the
# entry FORMAT_VERSION: verdicts are an additive record kind —
# older readers reject unknown "V ..." lines per-line (restore_rejected)
# and keep restoring plan entries, so artifacts stay forward-shareable.
VERDICT_VERSION = 1


class RestoreError(ValueError):
    """File or entry cannot be restored — caller falls back to cold lower."""


# ---------------------------------------------------------------------------
# primitive-tuple <-> JSON bijection
# ---------------------------------------------------------------------------
# The key/instruction world is tuples over (str, int, float, bool, bytes,
# None).  JSON arrays stand in for tuples (no bare lists exist in any
# payload), bytes are base64-tagged; everything else maps natively.
#
# Decoding is deliberately *shallow*: ``parse_payload`` runs C-speed
# ``json.loads`` and leaves arrays as lists — a full Python tuple-walk
# measured ~10x the json cost on real entries, most of which the restore
# path never needs as tuples.  ``deep_tuple`` converts exactly the spots
# where tuple-ness is semantic: dict keys (outer/bucket keys, death
# sites, param paths) and the pad layouts of merge buffers.


def _to_jsonable(obj):
    if isinstance(obj, (tuple, list)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, np.generic):
        # numpy scalars (e.g. split sizes off an int64 computation)
        # compare equal to their Python values, so demoting them keeps
        # round-tripped keys matching live ones
        return obj.item()
    return obj


def deep_tuple(obj):
    """Recursively convert decoded JSON (lists, bytes tags) to the
    hashable tuple world keys live in."""
    t = type(obj)
    if t is list:
        return tuple([deep_tuple(x) for x in obj])
    if t is dict:
        if len(obj) == 1 and "__bytes__" in obj:
            try:
                return base64.b64decode(obj["__bytes__"])
            except (ValueError, TypeError) as e:
                raise RestoreError(f"bad bytes tag: {e}") from None
        return {k: deep_tuple(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# key helpers
# ---------------------------------------------------------------------------


_DIGEST_MEMO: dict = {}


def key_digest(key) -> str:
    """Stable printable digest of a raw (repr-able) key tuple.

    Memoized: digesting is pure, and the repr of a structural outer key
    costs ~40us — paid once per key per process instead of once per
    store lookup (hashing the tuple itself is C-speed)."""
    d = _DIGEST_MEMO.get(key)
    if d is None:
        if len(_DIGEST_MEMO) > 4096:
            _DIGEST_MEMO.clear()
        d = _DIGEST_MEMO[key] = hashlib.sha256(
            repr(key).encode()).hexdigest()[:16]
    return d


def persistable_key(key) -> bool:
    """True when ``key`` round-trips through the JSON encoding *and*
    stays meaningful in another process.

    ``fused_fn_identity`` falls back to ``("id", id(fn))`` for opaque
    closures — a process-local identity that would never match after a
    restart, so entries carrying one are excluded from the artifact.
    """
    if isinstance(key, tuple):
        if len(key) == 2 and key[0] == "id" and isinstance(key[1], int):
            return False
        return all(persistable_key(k) for k in key)
    return isinstance(key, (str, int, float, bool, bytes, type(None)))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_analysis(ana: AnalysisResult) -> dict:
    """Bucket-invariant analysis parts (per-bucket fields are stored with
    each bucket record: ``plan_fp``; ``buffer_bytes`` is re-derived from
    the live graph at rehydration, exactly as ``specialize`` does)."""
    return {
        "prealloc": tuple(sorted(ana.prealloc)),
        # (key, value) pairs: death keys are (tid, part) tuples, which
        # JSON objects cannot key on
        "death": tuple(sorted(ana.death.items(), key=repr)),
        "reads": tuple(tuple(tuple(r) for r in step) for step in ana.reads),
        "writes": tuple(tuple(tuple(w) for w in step)
                        for step in ana.writes),
        "n_steps": ana.n_steps,
    }


def _encode_instr(ins: Instr, writes_row, tensors) -> tuple:
    writes = []
    for (slot, buf), (t, _p) in zip(ins.writes, writes_row):
        if buf is not None:
            bslot, start, pad_cfg, _axis = buf
            buf = (bslot, start, pad_cfg,
                   dtype_name(tensors[t].dtype) if pad_cfg is not None
                   else None)
        writes.append((slot, buf))
    return (ins.reads, tuple(writes), ins.frees, bool(ins.fused),
            ins.param_ix, ins.member_pairs, ins.fused_pairs,
            ins.ext_inputs, ins.ext_outputs, ins.label)


def encode_lowered(bucket, lowered: LoweredPlan) -> dict:
    """One shape bucket of an outer entry.  ``Instr.fn`` / ``.step`` are
    dropped; stats keep only scalars."""
    stats = {k: v for k, v in lowered.stats.items()
             if isinstance(v, (int, float, str))
             and k not in ("captures", "replays")}
    tensors = lowered.graph.tensors
    return {
        "bucket": bucket,
        "plan_fp": lowered.fingerprint,
        "split_sizes": tuple(lowered.split_sizes),
        "capture": bool(lowered.capture),
        "n_slots": lowered.n_slots,
        "input_slots": lowered.input_slots,
        "output_slots": lowered.output_slots,
        "param_paths": lowered.param_paths,
        "instrs": tuple(_encode_instr(i, w, tensors) for i, w in
                        zip(lowered.instrs, lowered.analysis.writes)),
        "stats": stats,
    }


def entry_line(outer, analysis: dict, canonical, buckets: Iterable[dict],
               fp2: Optional[str] = None) -> str:
    """One outer entry.  The full outer key is NOT serialized — entries
    are addressed by its digest (the fp2 field), which keeps the
    payload ~40% smaller and the restore path off a large decode; only
    the human-auditable ``salt`` component is embedded as a cross-check.
    A digest collision is caught downstream: ``rehydrate`` verifies the
    live plan fingerprint before an entry ever serves."""
    payload = json.dumps(
        _to_jsonable({"salt": outer[1] if len(outer) > 1 else "",
                      "analysis": analysis, "canonical": canonical,
                      "buckets": tuple(buckets)}),
        sort_keys=True, separators=(",", ":"))
    check = hashlib.sha256(payload.encode()).hexdigest()[:16]
    return f"E {FORMAT_VERSION} {fp2 or key_digest(outer)} {check} {payload}"


# ---------------------------------------------------------------------------
# verdict records (autotuner decisions)
# ---------------------------------------------------------------------------


def verdict_line(context_fp: str, payload: dict) -> str:
    """One autotuner verdict record::

        V <verdict_version> <context-fp> <sha256[:16] of payload> <payload>

    Addressed by the *context fingerprint* (``core.autotune``), not the
    plan outer key: a verdict decides which strategy a context gets
    before any plan exists.  The payload is the compact-JSON
    ``TuningVerdict.to_payload()`` dict — pure primitives, no pickle."""
    body = json.dumps(_to_jsonable(payload), sort_keys=True,
                      separators=(",", ":"))
    check = hashlib.sha256(body.encode()).hexdigest()[:16]
    return f"V {VERDICT_VERSION} {context_fp} {check} {body}"


def split_verdict_line(line: str) -> tuple:
    """Validate and parse a verdict line -> ``(context_fp, payload_dict)``.
    Raises ``RestoreError`` on a malformed, version-mismatched or
    corrupt record (caller skips it: cold re-tune, never a crash)."""
    parts = line.split(" ", 4)
    if len(parts) != 5 or parts[0] != "V":
        raise RestoreError(f"malformed verdict line: {line[:40]!r}")
    _, ver, fp, check, body = parts
    if ver != str(VERDICT_VERSION):
        raise RestoreError(
            f"verdict version {ver} != {VERDICT_VERSION}")
    if hashlib.sha256(body.encode()).hexdigest()[:16] != check:
        raise RestoreError("verdict checksum mismatch (corrupt payload)")
    try:
        payload = json.loads(body)
    except (ValueError, TypeError) as e:
        raise RestoreError(f"unparseable verdict payload: {e}") from None
    if not isinstance(payload, dict):
        raise RestoreError("verdict payload is not an object")
    return fp, payload


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def split_entry_line(line: str) -> tuple:
    """Cheap validation pass: ``(fp2_digest, payload_str)``.

    Verifies the marker, per-entry format version and checksum without
    paying the JSON parse — full parsing is deferred to first use so
    loading a large store stays O(bytes hashed).
    """
    parts = line.split(" ", 4)
    if len(parts) != 5 or parts[0] != "E":
        raise RestoreError(f"malformed entry line: {line[:40]!r}")
    _, ver, fp2, check, payload = parts
    if ver != str(FORMAT_VERSION):
        raise RestoreError(f"entry format version {ver} != {FORMAT_VERSION}")
    if hashlib.sha256(payload.encode()).hexdigest()[:16] != check:
        raise RestoreError("entry checksum mismatch (corrupt payload)")
    return fp2, payload


def parse_payload(payload: str) -> dict:
    """Parse an entry payload.  Arrays stay lists (see ``deep_tuple``);
    only the key-bearing fields — ``canonical`` and each bucket
    record's ``bucket`` — are converted to tuples here, so they compare
    and hash against live keys."""
    try:
        obj = json.loads(payload)
    except (ValueError, TypeError, RecursionError) as e:
        raise RestoreError(f"unparseable entry payload: {e}") from None
    if not isinstance(obj, dict) or not {"salt", "analysis", "canonical",
                                         "buckets"} <= set(obj):
        raise RestoreError("entry payload missing required fields")
    try:
        obj["canonical"] = deep_tuple(obj["canonical"])
        for rec in obj["buckets"]:
            rec["bucket"] = deep_tuple(rec["bucket"])
    except (TypeError, KeyError) as e:
        raise RestoreError(f"malformed entry keys: {e}") from None
    return obj


def decode_analysis(rec: dict, graph, plan_fp: str) -> AnalysisResult:
    """Rebuild the bucket-invariant analysis.  ``reads``/``writes`` keep
    their decoded (list) spine as-is — every consumer unpacks or
    iterates them, and the parse owns the objects — while ``death``
    keys are re-tupled (dict keys)."""
    prealloc = set(rec["prealloc"])
    return AnalysisResult(
        prealloc=prealloc,
        death={tuple(k): v for k, v in rec["death"]},
        reads=rec["reads"],
        writes=rec["writes"],
        buffer_bytes=sum(graph.tensors[t].nbytes for t in prealloc),
        n_steps=rec["n_steps"],
        plan_fingerprint=plan_fp)


def rehydrate(record: dict, analysis_rec: dict, graph, plan,
              struct_key: tuple, bind_fns: bool = True) -> LoweredPlan:
    """Rebuild a servable ``LoweredPlan`` from a bucket record.

    Callables are rebound from the caller's live ``(graph, plan)`` —
    the outer-key match guarantees they are the ones the skeleton was
    lowered against; the plan fingerprint is still cross-checked so a
    key collision degrades to a clean ``RestoreError`` (cold lower),
    never a silent wrong replay.

    ``bind_fns=False`` rebuilds a **canonical skeleton** instead: the
    caller's plan belongs to a *different* shape bucket of the same
    structure, so the fingerprint/split checks are skipped and every
    ``Instr.fn`` is left ``None`` — such a skeleton exists only to feed
    ``specialize()``, which rebinds all callables and rewrites all
    shape-dependent fields, and must never be executed directly.
    """
    # the whole rebuild runs under one RestoreError net: a checksum-valid
    # but schema-malformed record (missing field, wrong arity) must
    # degrade to a cold lower, never crash the serving request
    try:
        steps = plan.steps
        if len(record["instrs"]) != len(steps):
            raise RestoreError(
                f"restored entry has {len(record['instrs'])} instrs, plan "
                f"has {len(steps)} steps")
        plan_fp = record["plan_fp"]
        if bind_fns:
            plan_fp = plan.fingerprint()
            if record["plan_fp"] != plan_fp:
                raise RestoreError(
                    f"restored entry was lowered for plan "
                    f"{record['plan_fp']}, got plan {plan_fp}")
            if tuple(record["split_sizes"]) != tuple(plan.split_sizes):
                raise RestoreError(
                    "restored entry split sizes disagree with plan")
        nodes = graph.nodes
        tensors = graph.tensors
        writes_rows = analysis_rec["writes"]
        instrs = []
        # this loop is the whole redeem cost, so it stays allocation-
        # light: reads/frees keep their decoded list spine (only ever
        # unpacked or iterated), tuples are rebuilt only where
        # hashability or a ``narrow`` argument demands it, and Instr is
        # materialized via __new__ + __dict__ (the dataclass __init__
        # measured ~3x slower here, same reasoning as ``specialize``'s
        # positional rebuild)
        new_instr = object.__new__
        for i, (enc, step) in enumerate(zip(record["instrs"], steps)):
            (reads, writes_e, frees, fused, param_ix, member_pairs,
             fused_pairs, ext_in, ext_out, label) = enc
            writes = []
            for j, (slot, buf) in enumerate(writes_e):
                if buf is not None:
                    bslot, start, pad_cfg, _dtype = buf
                    # the batch axis of the merged tensor, from the graph
                    axis = tensors[writes_rows[i][j][0]].batch_dim
                    if pad_cfg is not None:
                        buf = (bslot, None, tuple(map(tuple, pad_cfg)),
                               axis)
                    else:
                        buf = (bslot, tuple(start), None, axis)
                writes.append((slot, buf))
            fused = bool(fused)
            if fused != (step.kind == "fused"):
                raise RestoreError(
                    f"restored instr {label!r} fused-ness disagrees with "
                    f"plan step kind {step.kind!r}")
            if not bind_fns:
                fn, live_step = None, None
            elif fused:
                if step.replace_fn is None:
                    raise RestoreError(
                        f"restored fused instr {label!r} has no live "
                        "replacement kernel in the plan")
                fn, live_step = step.replace_fn, step
            else:
                fn, live_step = nodes[step.handles[0].oid].fn, None
            ins = new_instr(Instr)
            ins.__dict__ = {
                "fn": fn, "reads": reads, "writes": writes, "frees": frees,
                "fused": fused, "param_ix": param_ix,
                # param paths key pdicts at execution time: re-tuple
                # (with empty fast paths — most instrs carry neither)
                "member_pairs": None if member_pairs is None else tuple(
                    (tuple(p), ix) for p, ix in member_pairs),
                "fused_pairs": tuple((tuple(p), ix)
                                     for p, ix in fused_pairs)
                if fused_pairs else (),
                "step": live_step,
                "ext_inputs": tuple(map(tuple, ext_in)) if ext_in else (),
                "ext_outputs": tuple(map(tuple, ext_out))
                if ext_out else (),
                "label": label}
            instrs.append(ins)
        analysis = decode_analysis(analysis_rec, graph, plan_fp)
        stats = dict(record["stats"])
        stats["restored"] = stats.get("restored", 0) + 1
        return LoweredPlan(
            graph=graph, split_sizes=tuple(record["split_sizes"]),
            instrs=tuple(instrs), input_slots=tuple(record["input_slots"]),
            output_slots=tuple(record["output_slots"]),
            param_paths=tuple(record["param_paths"]),
            n_slots=record["n_slots"], fingerprint=plan_fp,
            analysis=analysis, capture=bool(record["capture"]),
            struct_key=struct_key, stats=stats)
    except (KeyError, IndexError, TypeError, ValueError,
            AttributeError) as e:
        if isinstance(e, RestoreError):
            raise
        raise RestoreError(f"malformed restored entry: {e}") from None


# ---------------------------------------------------------------------------
# file I/O
# ---------------------------------------------------------------------------


def write_store(path: str, entry_lines: Iterable[str],
                one_shot: Iterable[tuple] = (),
                fingerprint_version: int = 2) -> int:
    """Atomically write a store file; returns the number of entries."""
    lines = sorted(entry_lines, key=lambda s: s.split(" ", 3)[2])
    header = json.dumps(
        {"magic": MAGIC, "format_version": FORMAT_VERSION,
         "fingerprint_version": fingerprint_version,
         "entries": len(lines),
         "one_shot": sorted(list(d) for d in one_shot)},
        sort_keys=True)
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".planstore-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(header + "\n")
            for line in lines:
                f.write(line + "\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(lines)


def read_store(path: str, fingerprint_version: int = 2):
    """Validate the header and return ``(one_shot, raw_entry_lines)``.

    Raises ``RestoreError`` for a missing/corrupt/version-mismatched
    file; per-entry problems are left for ``split_entry_line``.
    """
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise RestoreError(f"cannot read plan store: {e}") from None
    lines = text.splitlines()
    if not lines:
        raise RestoreError("empty plan store file")
    try:
        header = json.loads(lines[0])
    except (ValueError, TypeError) as e:
        raise RestoreError(f"corrupt plan store header: {e}") from None
    if not isinstance(header, dict) or header.get("magic") != MAGIC:
        raise RestoreError("not a plan store file (bad magic)")
    if header.get("format_version") != FORMAT_VERSION:
        raise RestoreError(
            f"plan store format version {header.get('format_version')} "
            f"!= supported {FORMAT_VERSION}")
    if header.get("fingerprint_version") != fingerprint_version:
        raise RestoreError(
            f"plan store fingerprint version "
            f"{header.get('fingerprint_version')} != {fingerprint_version}")
    one_shot = {tuple(d) for d in header.get("one_shot", ())
                if isinstance(d, (list, tuple)) and len(d) == 2}
    return one_shot, [ln for ln in lines[1:] if ln.strip()]
