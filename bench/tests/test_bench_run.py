"""Whole runs of the serving driver on the CPU at smoke sizes, past the
harness's look for a card: a sound run is correct, a run whose timed
path alters the tokens it serves is not; what the harness and the
references load; a run without a card prints no result."""
import json
import os
import subprocess
import sys
import tempfile
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import catalog  # noqa: E402

SMOKE_ENGINE = {"max_batch": 8, "s_max": 160,
                "prefill_buckets": [16, 32, 64], "prefill_batch": 4}


def smoke_run(cell_name: str, seed: int, seconds: float = 6.0,
              check_requests: int = 2, min_tokens: int = 12) -> dict:
    """The cell's driver at the port's smoke sizes on the CPU: the cell's
    traffic cut to 8 clients (or 12 requests a second) and short
    lengths, and the judge's sample to ``check_requests`` requests and
    at least ``min_tokens`` served tokens (a loaded CPU finishes few
    requests in a short window); everything else as the cell states
    it."""
    cell = catalog.workload(cell_name)
    cell["engine"] = dict(SMOKE_ENGINE)
    cfg = catalog.config(cell["config"])
    cfg.update(num_layers=2, hidden_size=32, num_attention_heads=4,
               multi_query_group_num=2, kv_channels=8, ffn_hidden_size=64,
               padded_vocab_size=128)
    cfg["bench"] = dict(cfg["bench"], smoke=True)
    spec = catalog.traffic(cell["traffic"])
    spec["prompt"] = {"dist": "uniform", "min": 4, "max": 60}
    spec["output"] = {"dist": "uniform", "min": 6, "max": 16}
    spec["settle_s"] = 0.2
    if spec["loop"] == "closed":
        spec.update(clients=8, pool=64)
    else:
        spec.update(rate_per_s=12.0, tail_s=5.0)
    orig = catalog.traffic
    catalog.traffic = lambda name: spec
    drv = catalog.driver(cell["driver"])
    drv.CHECK_REQUESTS, drv.CHECK_TOKENS_MIN = check_requests, min_tokens
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = types.SimpleNamespace(
            seed=seed, seconds=seconds, trace=0, control=False,
            plan_store=os.path.join(tempfile.mkdtemp(), "p.plans"))
        return drv.run(cell, cfg, args, torch.device("cpu"), 0.0)
    finally:
        catalog.traffic = orig
        torch.set_num_threads(threads)


def _checks(res) -> dict:
    return {name: (v, lim) for name, v, lim in res["checks"]}


@pytest.mark.parametrize("cell", ["chatglm3-6b.chat-sat",
                                  "chatglm3-6b.chat-rate"])
def test_a_sound_run_is_correct(cell):
    res = smoke_run(cell, 2 ** 31 + 21)
    c = _checks(res)
    assert res["correct"], c
    assert c["max_logit_gap"][0] < c["max_logit_gap"][1]
    assert res["ctx"]["requests"] and res["failed"] == 0


def test_every_request_due_in_the_window_is_waited_for():
    """An open loop: the requests due in the window's last step are sent
    after it and waited for like the others, so each has its first
    token."""
    res = smoke_run("chatglm3-6b.chat-rate", 2 ** 31 + 24, seconds=3.0)
    t0, t1 = res["ctx"]["window"]
    due = [r for r in res["ctx"]["requests"] if t0 <= r["due"] <= t1]
    assert due and all(r["emits"] for r in due)


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from repro_torch.serve import engine
    real = engine.sample_tokens

    def altered(logits, *a, **kw):
        tok = real(logits, *a, **kw)
        return (tok + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_tokens", altered)
    res = smoke_run("chatglm3-6b.chat-sat", 2 ** 31 + 22)
    c = _checks(res)
    assert not res["correct"]
    assert c["max_logit_gap"][0] > c["max_logit_gap"][1], c


def test_one_altered_row_a_step_is_not_correct(monkeypatch):
    """One row's token altered in each decode step: the widest gap, not a
    mean, catches it (every finished request is compared, so the altered
    row's are among them)."""
    from repro_torch.serve import engine
    real = engine.sample_tokens

    def altered(logits, *a, **kw):
        tok = real(logits, *a, **kw).clone()
        tok[0] = (tok[0] + 7) % logits.shape[-1]
        return tok
    monkeypatch.setattr(engine, "sample_tokens", altered)
    res = smoke_run("chatglm3-6b.chat-sat", 2 ** 31 + 23,
                    check_requests=10 ** 6)
    c = _checks(res)
    assert not res["correct"]
    assert c["max_logit_gap"][0] > c["max_logit_gap"][1], c


_LOADED = """
import json, os, sys, types, tempfile
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
sys.argv = ["x"]
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in list(sys.modules)}})))
"""


def _loaded(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _LOADED.format(root=ROOT, body=body)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    body = f"""
sys.path.insert(0, {os.path.dirname(__file__)!r})
import bench.run, bench.control
from test_bench_run import smoke_run
from bench.harness import catalog
for cell in ("chatglm3-6b.chat-sat", "chatglm3-6b.chat-rate"):
    res = smoke_run(cell, 7, seconds=1.0)
    for table in ("end_to_end", "per_layer"):
        bench.run.read_metrics(catalog, cell, table, res["ctx"])
catalog.driver("train")
"""
    tops = _loaded(body)
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_the_references_load_nothing_of_the_program():
    body = """
import torch
from bench.harness import catalog, judge, weights
for name in ("chatglm3", "zamba2"):
    catalog.reference(name)
ref = catalog.reference("chatglm3")
cfg = catalog.config("chatglm3-6b")
cfg.update(num_layers=1, hidden_size=16, num_attention_heads=2,
           multi_query_group_num=1, kv_channels=8, ffn_hidden_size=32,
           padded_vocab_size=64)
p = weights.make_params(ref.param_layout(cfg), 3, "cpu")
judge.logit_gaps(ref, p, cfg, [([1, 2, 3], [4, 5])], "cpu",
                 linear=judge.fp8_linear)
"""
    tops = _loaded(body)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, tops


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"),
         "--workload", "chatglm3-6b.chat-sat", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_train_driver_holds_the_step_to_the_reference():
    """The training driver at zamba2-1.2b's smoke sizes on the CPU: three
    graphed-path steps against the reference's three, then a window.
    Its loss and first gradients agree; the change after three steps is
    read for every leaf (the bf16 norm gains' is the program fault that
    keeps the cell out of the benchmark: PERF.md, Open questions)."""
    cfg = catalog.config("zamba2-1.2b")
    cfg.update(hidden_size=32, num_hidden_layers=4, mamba_d_state=16,
               mamba_headdim=8, num_attention_heads=4, num_key_value_heads=2,
               attention_head_dim=8, intermediate_size=64, vocab_size=128,
               chunk_size=8, attn_every=2)
    cfg["bench"] = dict(cfg["bench"], smoke=True)
    cell = {"name": "zamba2-1.2b.train-2k", "config": "zamba2-1.2b",
            "traffic": "train-2k", "chips": 1, "driver": "train",
            "remat": True,
            "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                          "weight_decay": 0.1, "grad_clip": 1.0,
                          "warmup": 3, "total_steps": 100000},
            "limits": {"loss_rel": 1e-3, "grad_norm_gap": 0.05}}
    orig = catalog.traffic
    catalog.traffic = lambda name: {"batch": 2, "seq": 32}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = types.SimpleNamespace(
            seed=2 ** 31 + 31, seconds=1.0, trace=0, control=None,
            plan_store=os.path.join(tempfile.mkdtemp(), "p.plans"))
        res = catalog.driver("train").run(cell, cfg, args,
                                          torch.device("cpu"), 0.0)
    finally:
        catalog.traffic = orig
        torch.set_num_threads(threads)
    assert res["correct"], res["checks"]
    assert res["ctx"]["steps"] >= 1 and res["failed"] == 0
    leaves = res["info"]["judge"]["leaves"]
    gains = [v["change"] for k, v in leaves.items() if k.endswith(".g")]
    assert gains and all(ref > 0 for _, ref in gains)
