"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline/count.py``)
held to the JAX package's ``roofline.hlo.analyze`` of the same steps.

The reference side runs once, in the subprocess of
``test_torch_distributed.run_reference`` (4 host devices): each cell's
``_build_global_*`` step at ``lowered=False``, ``jax.jit(fn,
in_shardings=...).lower(*in_sdss).compile().as_text()``, analyzed.  The
port's side is ``dryrun.count_step`` on the ``meta`` device at rank 0 of
a ``ShapeMesh`` of the same shape.  Cells: chatglm3-6b smoke (sequence
parallel) and smollm-135m smoke (not), prefill (B=4, S=64) and the tier-4
decode step (s_max 64), at one device and at data 2 x model 2;
deepseek-moe-16b smoke's prefill at data 2 x model 2; chatglm3-6b smoke's
train step (B=4, S=64, ``sequential``, remat) at data 2 x model 2.

What is held, and why:
  * FLOPs equal, exactly, for prefill and decode: the same products, the
    attention kernels' counted in full as the reference's dots are.
  * Collective payload bytes by kind: the port's are exactly half the
    reference's.  XLA's CPU backend runs no collective in bf16: its float
    normalization widens each one to f32 (the compiled module's
    ``_promoted`` reductions and convert fusions), so each reference
    payload is twice what the JAX package's step moves on its TPU.  The
    reference side checks that every collective of its unoptimized module
    carries bf16 and every one of its compiled module f32, so the factor
    is exactly 2; the port's collectives carry the bf16 of the step.
  * ``n_collectives`` equal.  A collective over an axis of one rank is
    kept and counted in both (XLA leaves it in the SPMD module; the dry
    run's ``Recorder`` records it); its wire bytes are 0.
  * The train step (its tolerance): FLOPs equal to the reference's plus
    three named sets of products, exactly.  (a) The flash backward kernel
    recomputes the scores: 5 products of 2 B S S H hd a layer, where the
    reference autodiffs ``_sdpa`` at S <= ``chunk_q`` and keeps the
    probabilities: 4.  (b) ``HeadLoss``'s backward recomputes each
    chunk's logits: one more (T, d) x (d, V/tp) product.  (c)
    ``torch.utils.checkpoint`` reruns a layer's whole forward, where XLA
    drops the recomputed values no gradient reads: the MLP's down
    projection, one (T, ff/tp) x (ff/tp, d) product a layer.  The
    payloads: every kind the reference has, at least its (widening
    undone) and within 1.25x, and no other kind; all-gather exactly.  The
    port reruns the checkpointed forward's collectives that XLA drops or
    merges, so n_collectives is at least the reference's.
  * HBM bytes are not held to the reference (XLA fuses, eager PyTorch
    does not); ``test_torch_roofline.py`` holds them to known answers,
    and ``chip_smoke.py``'s ``mesh`` phase holds the counts to the card.

On ``meta`` the lowered plans hold what the card's side streams hold:
the counted peak grows with the instructions put on side streams.

Then one full-width cell at ``pod16x16`` on ``meta`` (smollm-135m
``decode_32k``): the reference's record keys, ``argument_bytes`` equal
to rank 0's shard bytes from the global specs and placements, a
full-attention arch at ``long_500k`` skipped with the reference's reason;
and the CLI: the reference's flags, a record written with no GPU and no
process group.
"""
import contextlib
import json
import math
from pathlib import Path

import pytest
import torch

from test_torch_distributed import run_reference, save

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun

S, B = 64, 4
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
CELLS = ([(a, k, m) for a in ("chatglm3-6b", "smollm-135m")
          for k in ("prefill", "decode") for m in MESHES]
         + [("deepseek-moe-16b", "prefill", "2x2")])
TRAIN = ("chatglm3-6b", "train", "2x2")
COLLECTIVES = ("stablehlo.all_reduce", "stablehlo.all_gather",
               "stablehlo.reduce_scatter", "stablehlo.all_to_all",
               "stablehlo.collective_permute")


# ---------------------------------------------------------------------------
# the reference side (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------


def _collective_types(lowered) -> set:
    """Element types of every collective's result in the unoptimized
    StableHLO module."""
    from jax._src.lib.mlir import ir
    found = set()

    def visit(op):
        if op.name in COLLECTIVES:
            found.add(str(ir.RankedTensorType(op.results[0].type)
                          .element_type))
        return ir.WalkResult.ADVANCE
    lowered.compiler_ir("stablehlo").operation.walk(visit)
    return found


def _reference_cell(arch, kind, mesh_shape):
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.configs.base import ShapeConfig as JShape
    from repro.core.strategies import get_strategy
    from repro.launch.mesh import make_mesh_info
    from repro.launch.steps import (_build_global_decode_tiers,
                                    _build_global_prefill_step,
                                    _build_global_train_step)
    from repro.models.registry import build_model
    from repro.roofline.hlo import _SHAPE_RE, analyze
    from repro.train.step import TrainStepConfig
    d, m = mesh_shape
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         devices=jax.devices()[:d * m],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = jsmoke(arch)
    fsdp = cfg.fsdp_train if kind == "train" else cfg.fsdp_serve
    model = build_model(cfg, make_mesh_info(
        mesh, fsdp=fsdp, fsdp_resident=(kind == "decode")))
    shape = JShape("cell", S, B, kind)
    if kind == "train":
        fn, sdss, shd, *_ = _build_global_train_step(
            model, get_strategy("sequential"), shape, mesh,
            tcfg=TrainStepConfig(lowered=False))
    elif kind == "prefill":
        fn, sdss, shd, *_ = _build_global_prefill_step(
            model, get_strategy("dynamic"), shape, mesh, lowered=False)
    else:
        fn, sdss, shd, *_ = _build_global_decode_tiers(
            model, get_strategy("dynamic"), shape, mesh, tiers=(B,),
            lowered=False)[B]
    lowered = jax.jit(fn, in_shardings=shd).lower(*sdss)
    hlo = lowered.compile().as_text()
    compiled_types = set()
    for line in hlo.splitlines():
        if any(f" {k}(" in line for k in ("all-reduce", "all-gather",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute")):
            compiled_types.add(_SHAPE_RE.findall(line.split("=", 1)[1])[0][0])
    r = analyze(hlo)
    return {"flops": r["flops"], "collectives": r["collectives"],
            "n_collectives": r["n_collectives"],
            "unoptimized_types": _collective_types(lowered),
            "compiled_types": compiled_types}


def _reference(out):
    import argparse
    import sys

    from repro.configs import get_config as jconfig
    res = {"cells": {c: _reference_cell(c[0], c[1], MESHES[c[2]])
                     for c in CELLS + [TRAIN]}}
    # the CLI's flags, read by a spy on add_argument (main() has no argv)
    import repro.launch.dryrun as jdry
    seen = []
    real = argparse.ArgumentParser.add_argument

    def spy(self, *a, **k):
        seen.append(a[0])
        return real(self, *a, **k)
    argparse.ArgumentParser.add_argument = spy
    sys.argv = ["dryrun", "--help"]
    try:
        jdry.main()
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.add_argument = real
    res["flags"] = [f for f in seen if f != "-h"]
    res["skip"] = jdry.skip_reason(jconfig("chatglm3-6b"), "long_500k")
    save(res, Path(out) / "ref.pkl")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_dryrun",
                         tmp_path_factory.mktemp("dryrun"), devices=4)


def _port(arch, kind, mesh):
    shape = ShapeConfig("cell", S, B, kind)
    strategy = "sequential" if kind == "train" else "dynamic"
    return dryrun.count_step(get_smoke_config(arch), shape,
                             dryrun.ShapeMesh(MESHES[mesh],
                                              ("data", "model")),
                             strategy=strategy)["counts"]


def _side(i: int) -> int:
    return 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_meta_run_holds_what_side_streams_hold(monkeypatch, mesh):
    """On ``meta`` the lowered plans run in order and keep alive, until
    each call returns, what the card's stream program holds there (what
    its side streams touch): the counted peak grows from the one-stream
    program to the plans' own to every instruction on a side stream, and
    the first is below the last."""
    from repro_torch.core import streams
    from repro_torch.roofline.count import Counter
    made = []

    class Kept(Counter):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)
    monkeypatch.setattr(dryrun, "Counter", Kept)
    peaks = {}
    for name, ctx in (("one", streams.one_stream),
                      ("own", contextlib.nullcontext),
                      ("side", lambda: streams.assigned(_side))):
        with ctx():
            dryrun.count_step(get_smoke_config("chatglm3-6b"),
                              ShapeConfig("cell", S, B, "prefill"),
                              dryrun.ShapeMesh(MESHES[mesh],
                                               ("data", "model")))
        peaks[name] = made[-1].peak
    assert peaks["one"] <= peaks["own"] <= peaks["side"]
    assert peaks["one"] < peaks["side"]


# ---------------------------------------------------------------------------
# prefill and decode: held to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_counts_equal_reference(ref, cell):
    want = ref["cells"][cell]
    got = _port(*cell)
    assert got["flops"] == want["flops"]
    # XLA's CPU backend widened every (bf16) collective to f32: factor 2
    assert want["unoptimized_types"] <= {"bf16"}
    assert want["compiled_types"] <= {"f32"}
    assert {k: 2 * v for k, v in got["collectives"].items()} \
        == want["collectives"]
    assert got["n_collectives"] == want["n_collectives"]


def test_train_step_counts_against_reference(ref):
    """The train step: FLOPs equal to the reference's plus the three named
    sets of products (module docstring), exactly; payloads within the
    stated tolerance."""
    want = ref["cells"][TRAIN]
    got = _port(*TRAIN)
    cfg = get_smoke_config("chatglm3-6b")
    tp, dp = 2, 2
    T = B // dp * S                          # tokens a rank
    attn = 2.0 * (B // dp) * S * S * (cfg.n_heads // tp) * cfg.hd
    head = 2.0 * T * cfg.d_model * (cfg.vocab // tp)
    down = 2.0 * T * (cfg.d_ff // tp) * cfg.d_model
    assert got["flops"] == want["flops"] + cfg.n_layers * (attn + down) \
        + head
    assert want["unoptimized_types"] <= {"bf16", "f32"}
    coll = {k: v for k, v in got["collectives"].items() if k != "total"}
    ref_coll = {k: v for k, v in want["collectives"].items() if k != "total"}
    assert set(coll) == set(ref_coll)
    assert 2 * coll["all-gather"] == ref_coll["all-gather"]
    for kind, nbytes in ref_coll.items():
        assert nbytes <= 2 * coll[kind] <= 1.25 * nbytes, kind
    assert got["n_collectives"] >= want["n_collectives"]


# ---------------------------------------------------------------------------
# a full-width cell at the production mesh, the record, the CLI
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "status", "strategy", "chips",
            "attn_sub", "substituted_bytes", "phase", "build_s", "lower_s",
            "compile_s", "memory", "cost", "collective_payload_bytes",
            "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_per_device"}


def _shard_bytes(specs, places, sizes) -> int:
    """Rank 0's bytes of a global spec tree cut by its placements."""
    if isinstance(specs, dict):
        sub = places if isinstance(places, dict) else {}
        return sum(_shard_bytes(v, sub.get(k, ()), sizes)
                   for k, v in specs.items())
    n = 1
    for i, dim in enumerate(specs.shape):
        axes = places[i] if i < len(places) else ()
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * specs.dtype.itemsize


def test_full_width_decode_cell_at_production_mesh(monkeypatch):
    """smollm-135m as published, ``decode_32k`` at ``pod16x16`` on
    ``meta``: the reference's record keys, a finite positive roofline, and
    rank 0's argument bytes equal to its shards of the global specs."""
    built = {}
    real = dryrun.step_inputs

    def keep(step, mesh, train):
        built["step"], built["mesh"] = step, mesh
        return real(step, mesh, train)
    monkeypatch.setattr(dryrun, "step_inputs", keep)
    rec = dryrun.run_cell("smollm-135m", "decode_32k", verbose=False)
    assert set(rec) == REF_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == "pod16x16" and rec["phase"] == "decode"
    step, sizes = built["step"], {"data": 16, "model": 16}
    want = sum(_shard_bytes(s, p, sizes) for s, p in
               zip(step.in_specs, step.in_placements))
    assert rec["memory"]["argument_bytes"] == want
    mem = rec["memory"]
    assert mem["peak_per_device"] == (mem["argument_bytes"]
                                      + mem["output_bytes"]
                                      + mem["temp_bytes"]
                                      - mem["alias_bytes"])
    # the caches are updated in place and handed back
    assert mem["alias_bytes"] > 0
    rl = rec["roofline"]
    for term in ("t_compute", "t_memory", "t_collective", "t_bound"):
        assert math.isfinite(rl[term]) and rl[term] > 0, term
    assert rec["collective_payload_bytes"]["total"] > 0
    assert not torch.distributed.is_initialized()


def test_full_attention_long_500k_skipped_with_reference_reason(ref):
    rec = dryrun.run_cell("chatglm3-6b", "long_500k", verbose=False)
    assert rec == {"arch": "chatglm3-6b", "shape": "long_500k",
                   "mesh": "pod16x16", "status": "skipped",
                   "reason": ref["skip"]}
    assert dryrun.skip_reason(get_config("mamba2-2.7b"), "long_500k") is None


def test_cli_flags_are_the_references(ref):
    import argparse
    seen = []
    real = argparse.ArgumentParser.add_argument

    def spy(self, *a, **k):
        seen.append(a[0])
        return real(self, *a, **k)
    argparse.ArgumentParser.add_argument = spy
    try:
        with pytest.raises(SystemExit):
            dryrun.main(["--help"])
    finally:
        argparse.ArgumentParser.add_argument = real
    assert [f for f in seen if f != "-h"] == ref["flags"]


def test_cli_writes_record(monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch A --shape S`` (its
    ``main``) writes the record, with no card and no process group."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--attn-sub"])
    assert "all dry-run cells OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__pod16x16"
                      "__pallas.json").read_text())
    assert set(rec) == REF_KEYS and rec["status"] == "ok"
    assert set(rec["substituted_bytes"]) == {"flashable_attention",
                                             "flashable_decode"}
    assert rec["substituted_bytes"]["flashable_decode"] > 0
    assert not torch.distributed.is_initialized()
    assert SHAPES["decode_32k"].global_batch == 128
