"""The harness on the CPU: it finds its pieces by name, its traffic and
weights repeat for a seed, and its frozen arithmetic equals the
program's at the cells' shapes."""
import json
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import catalog, flops, traffic, weights  # noqa: E402

BENCH = catalog.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if m["name"] != "setup_s"
                    and cell in m.get("workloads", CELLS)]
        assert reported and catalog.metrics_of(cell, "per_layer")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_each_cell_by_name(cell):
    w = catalog.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert (w["config"], w["traffic"], w["chips"]) == \
        (entry["config"], entry["traffic"], entry["chips"]) == \
        (cell.split(".")[0], cell.split(".", 1)[1], 1)
    cfg = catalog.config(w["config"])
    assert catalog.reference(cfg["bench"]["reference"]).param_layout(cfg)
    assert catalog.traffic(w["traffic"])
    assert callable(catalog.driver(w["driver"]).run)
    for table in ("end_to_end", "per_layer"):
        for m in catalog.metrics_of(cell, table):
            assert callable(catalog.reader(m["name"]).read)


def test_each_config_file_is_the_one_benchmark_json_names():
    for c in BENCH["configs"]:
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert catalog.config(c["name"])["source"] == c["source"]


@pytest.mark.parametrize("mix", ["chat-sat", "chat-rate", "decode-long"])
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(mix):
    spec = catalog.traffic(mix)
    a = traffic.serve_traffic(spec, 3_000_000_017, 65024, 30.0)
    b = traffic.serve_traffic(spec, 3_000_000_017, 65024, 30.0)
    c = traffic.serve_traffic(spec, 3_000_000_018, 65024, 30.0)
    key = [(len(r.prompt), r.max_new, r.due_s, r.prompt[:4].tolist())
           for r in a.requests]
    assert key == [(len(r.prompt), r.max_new, r.due_s, r.prompt[:4].tolist())
                   for r in b.requests]
    assert key != [(len(r.prompt), r.max_new, r.due_s,
                    r.prompt[:4].tolist()) for r in c.requests]
    # the same sizes for every seed, in another order (the staggered first
    # wave of a closed loop aside)
    skip = a.clients if spec["loop"] == "closed" else 0
    assert sorted(len(r.prompt) for r in a.requests) == \
        sorted(len(r.prompt) for r in c.requests)
    if not skip:
        assert sorted(r.max_new for r in a.requests) == \
            sorted(r.max_new for r in c.requests)
        gaps = np.diff([r.due_s for r in a.requests])
        assert abs(gaps.mean() * spec["rate_per_s"] - 1) < 0.05
    lo, hi = spec["prompt"]["min"], spec["prompt"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in a.requests)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 65024
               for r in a.requests)


def test_quantile_lengths_follow_the_distribution():
    x = traffic.quantile_lengths({"dist": "lognormal", "median": 1024,
                                  "sigma": 0.6, "min": 64, "max": 2048},
                                 1001)
    assert x[500] == 1024 and x.min() >= 64 and x.max() == 2048
    u = traffic.quantile_lengths({"dist": "uniform", "min": 1024,
                                  "max": 2048}, 100)
    assert u.min() >= 1024 and u.max() <= 2048 and abs(u.mean() - 1536) < 2


def test_weights_repeat_for_a_seed_and_follow_their_init():
    layout = [(("a", "w"), (64, 32), torch.bfloat16, "fan_in"),
              (("a", "g"), (32,), torch.bfloat16, "gain"),
              (("b", "A_log"), (3, 8), torch.float32,
               ("log_uniform", 1.0, 16.0)),
              (("b", "dt"), (3, 8), torch.float32,
               ("inv_softplus_log_uniform", 1e-3, 1e-1))]
    p = weights.make_params(layout, 2 ** 31 + 5, "cpu")
    q = weights.make_params(layout, 2 ** 31 + 5, "cpu")
    r = weights.make_params(layout, 2 ** 31 + 6, "cpu")
    for (_, x), (_, y), (_, z) in zip(weights.leaves(p), weights.leaves(q),
                                      weights.leaves(r)):
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert abs(p["a"]["w"].float().std().item() - 1 / math.sqrt(64)) < 0.03
    assert abs(p["a"]["g"].float().mean().item() - 1) < 0.1
    a = torch.exp(p["b"]["A_log"])
    assert a.min() >= 1 and a.max() <= 16
    dt = torch.nn.functional.softplus(p["b"]["dt"])
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001


@pytest.mark.parametrize("config", ["chatglm3-6b", "zamba2-1.2b"])
def test_benchmark_layout_is_the_ports_at_full_size(config):
    from repro_torch.api import compile as port_compile
    from repro_torch.tree import leaves_with_paths
    cfg = catalog.config(config)
    ref = catalog.reference(cfg["bench"]["reference"])
    prog = port_compile(cfg["bench"]["arch"], device="cpu")
    segs, _ = prog.model.build_segments("prefill", 2, 2, s_max=4)
    port = {p: (tuple(t.shape), t.dtype) for p, t in
            leaves_with_paths(prog.model.param_shapes(segs))}
    assert port == {p: (tuple(s), dt) for p, s, dt, _ in
                    ref.param_layout(cfg)}
    pc = prog.model.cfg
    for field, key in cfg["bench"]["port_fields"].items():
        assert (pc.hd if field == "hd" else getattr(pc, field)) == cfg[key]


def test_serving_flops_count_every_matmul_weight_of_the_port():
    from repro_torch.configs import get_config
    cfg = catalog.config("chatglm3-6b")
    m = catalog.reference("chatglm3").dims(cfg)
    pc = get_config("chatglm3-6b")
    total, _ = pc.param_count()
    matmul = total - pc.vocab * pc.d_model - 2 * pc.d_model * pc.n_layers
    assert m["L"] * flops.dense_layer_params(m) + m["d"] * m["V"] == matmul
    # a prompt of n then its first token: the forward over n positions
    n = 1000
    want = (2.0 * (matmul - m["d"] * m["V"]) * n + 2.0 * m["d"] * m["V"]
            + 4.0 * m["L"] * m["H"] * m["hd"] * n * (n + 1) / 2)
    got = flops.serve_prompt_flops(m, n) + flops.serve_token_flops(m, n, 0)
    assert got == pytest.approx(want, rel=1e-12)


def test_train_flops_are_chip_smokes_at_the_cells_shape():
    import chip_smoke
    from repro_torch.api import compile as port_compile
    from repro_torch.tree import leaves_with_paths
    cfg = catalog.config("zamba2-1.2b")
    ref = catalog.reference("zamba2")
    prog = port_compile("zamba2-1.2b", device="cpu")
    segs, _ = prog.model.build_segments("train", 2, 2048)
    shapes = prog.model.param_shapes(segs)
    meta = {}
    for path, t in leaves_with_paths(shapes):
        node = meta
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(t.shape, dtype=t.dtype, device="meta")
    want, _ = chip_smoke.ssm_train_flops(prog.model, meta, 2, 2048)
    got = flops.ssm_train_flops(ref.dims(cfg), ref.param_layout(cfg), 2, 2048)
    assert got == pytest.approx(want, rel=1e-12)


def test_every_block_of_the_pool_holds_the_same_work():
    spec = catalog.traffic("chat-sat")
    a = traffic.serve_traffic(spec, 3_000_000_031, 65024, 30.0)
    b = traffic.serve_traffic(spec, 3_000_000_032, 65024, 30.0)
    k = traffic.BLOCK
    sums = [sum(len(r.prompt) for r in reqs[i:i + k])
            for reqs in (a.requests, b.requests)
            for i in range(0, len(reqs), k)]
    assert max(sums) - min(sums) < 0.1 * np.mean(sums)


def test_a_fixed_design_puts_every_seed_in_the_same_strata():
    n = 8 * traffic.BLOCK
    values = np.arange(n)
    a = traffic.stratified(values, np.random.default_rng(1),
                           np.random.default_rng(7))
    b = traffic.stratified(values, np.random.default_rng(2),
                           np.random.default_rng(7))
    assert sorted(a) == sorted(b) == list(values) and list(a) != list(b)
    assert np.array_equal(a // 8, b // 8)
    # each block still holds one value of every stratum
    assert all(sorted(blk // 8) == list(range(traffic.BLOCK))
               for blk in a.reshape(-1, traffic.BLOCK))
    spec = catalog.traffic("chat-rate")
    assert "design_seed" in spec
    x = traffic.serve_traffic(spec, 3_000_000_041, 65024, 51.0)
    y = traffic.serve_traffic(spec, 3_000_000_042, 65024, 51.0)
    per = len(x.requests) // traffic.BLOCK
    gaps = [np.diff([r.due_s for r in t.requests]) for t in (x, y)]
    ranks = [np.argsort(np.argsort(g)) for g in gaps]
    assert not np.array_equal(gaps[0], gaps[1])
    assert np.mean(ranks[0] // per == ranks[1] // per) > 0.95


def test_readers_of_host_times_leave_out_the_profilers_hold():
    reqs = [{"due": t, "admitted": t + (5.0 if 4 <= t <= 6 else 0.1),
             "emits": [t + (5.0 if 4 <= t <= 6 else 0.2)], "ok": True,
             "done": t + 1} for t in np.arange(0.0, 10.0, 0.1)]
    iters = [0.1] * 40 + [5.0] + [0.1] * 10
    ends = list(np.cumsum(iters))
    ctx = {"kind": "serve", "window": (0.0, 10.0), "window_s": 10.0,
           "requests": reqs, "wait_end": 20.0, "iters": iters,
           "iter_ends": ends, "host_skip": None}
    read = {m: catalog.reader(m).read for m in
            ("ttft_p95_s.rate", "queue_wait_p50_s.rate", "iter_ms.rate")}
    assert read["ttft_p95_s.rate"](ctx) == pytest.approx(5.0)
    assert read["iter_ms.rate"](ctx) == pytest.approx(
        sum(iters) / len(iters) * 1e3)
    ctx["host_skip"] = (3.9, 9.0)
    assert read["ttft_p95_s.rate"](ctx) == pytest.approx(0.2)
    assert read["queue_wait_p50_s.rate"](ctx) == pytest.approx(0.1)
    assert read["iter_ms.rate"](ctx) == pytest.approx(100.0)
