"""The readers of the serve engine's spans and counters on synthetic
windows: each reads its definition, None where its counters did not move
in the window, and None, without raising, from a program that has no
such spans or counters."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import catalog  # noqa: E402

READERS = ("host_ms.sat", "host_ms.rate", "prefill_pad_share.sat",
           "prefill_device_share.sat", "graph_gap_share.sat",
           "setup_plan_s", "setup_capture_s")

STATS0 = {
    "prefill_slots": 1000, "prefill_tokens": 700,
    "spans": {"serve.step": [10, 0.5], "serve.admit": [10, 0.1],
              "serve.sync": [10, 3.0], "stage.wait": [4, 2.0],
              "plan.build": [40, 1.25], "plan.restore": [20, 0.5],
              "graph.warm": [13, 6.0], "graph.settle": [13, 2.0],
              "graph.record": [13, 1.5], "bench.other": [1, 9.0]},
    "device_spans": {"decode/256": [8, 0.12, 0.01],
                     "prefill/4/2048": [2, 0.2, 0.002]},
}
STATS1 = {
    "prefill_slots": 3000, "prefill_tokens": 2200,
    "spans": {"serve.step": [110, 0.7], "serve.admit": [110, 0.3],
              "serve.sync": [110, 80.0], "stage.wait": [90, 7.0],
              "serve.decode": [100, 0.4], "serve.prefill": [5, 0.1],
              "plan.build": [40, 1.25], "plan.restore": [20, 0.5],
              "graph.warm": [13, 6.0], "graph.settle": [13, 2.0],
              "graph.record": [13, 1.5], "bench.other": [1, 9.0]},
    "device_spans": {"decode/256": [108, 1.62, 0.03],
                     "prefill/4/2048": [6, 0.8, 0.012],
                     "chunk/1/2048": [1, 0.3, 0.0],
                     "decode/128": [3, 0.08, 0.0]},
}


def ctx_of(s0, s1):
    return {"kind": "serve", "stats0": s0, "stats1": s1, "window_s": 3.0}


def read(name, ctx):
    return catalog.reader(name).read(ctx)


def test_each_reader_reads_its_definition():
    ctx = ctx_of(STATS0, STATS1)
    # (0.2 admit + 0.4 decode + 0.1 prefill + 0.2 step) s / 100 steps:
    # the two waits for the device, serve.sync and stage.wait, left out
    assert read("host_ms.sat", ctx) == pytest.approx(9.0)
    assert read("host_ms.rate", ctx) == read("host_ms.sat", ctx)
    assert read("prefill_pad_share.sat", ctx) == pytest.approx(25.0)
    # prefill 0.6 + chunk 0.3 of 1.5 + 0.6 + 0.3 + 0.08 device seconds
    assert read("prefill_device_share.sat", ctx) == pytest.approx(
        100 * 0.9 / 2.48)
    # gaps 0.02 + 0.01 s beside 2.48 s in graphs
    assert read("graph_gap_share.sat", ctx) == pytest.approx(
        100 * 0.03 / 2.51)
    assert read("setup_plan_s", ctx) == pytest.approx(1.75)
    assert read("setup_capture_s", ctx) == pytest.approx(9.5)


def test_readers_give_none_where_nothing_moved():
    ctx = ctx_of(STATS0, STATS0)
    for name in READERS[:5]:
        assert read(name, ctx) is None, name
    # set-up is read before the window: it needs no movement
    assert read("setup_plan_s", ctx) == pytest.approx(1.75)
    bare = {"spans": {"serve.step": [1, 0.1]}, "device_spans": {}}
    for name in ("setup_plan_s", "setup_capture_s"):
        assert read(name, ctx_of(bare, bare)) is None, name


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_for_a_program_without_spans(name):
    old = {"prefill_steps": 3, "decode_steps": 9}
    assert read(name, ctx_of(old, dict(old, decode_steps=20))) is None
    assert read(name, {"kind": "train"}) is None
