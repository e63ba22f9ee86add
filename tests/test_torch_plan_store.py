"""The port's PlanStore (src/repro_torch/core/plan_store.py, plan_serde.py,
verify.py:verify_lowered) against the JAX package's.

Each scenario of the JAX package's own ``tests/test_plan_store.py`` and
``tests/test_plan_persist.py`` runs twice, once per package, on the same
random networks (``test_torch_lowering.py``'s builders, with the same
numpy-seeded params and inputs), the reference lowering with
``capture=False`` (its jaxpr capture needs an API jax 0.9 removed).  Each
run asserts what the reference test asserts, and the two runs must
observe the same things:

  * the same ``snapshot()`` counters after every event, timing fields
    (``*_s``) excepted;
  * the same entries, parsed with ``parse_payload``, in the files
    ``save`` writes — and the same bytes;
  * ``verify_lowered``: the same diagnostic codes and anchors on fresh,
    specialized, rehydrated and tampered plans;
  * the same degradations on corrupt, garbage, version-mismatched and
    schema-malformed files.

A lowered plan's outputs equal its own package's interpreter bitwise and
the other package's within f32 round-off (``TOL``).
"""
import copy
import dataclasses
import functools
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.plan_serde as jserde
import repro.core.plan_store as jstore
import repro_torch.core as tcore
import repro_torch.core.plan_serde as tserde
import repro_torch.core.plan_store as tstore
from repro.core.verify import verify_lowered as jverify_lowered
from repro_torch.convert import params_from_numpy
from repro_torch.core.verify import verify_lowered as tverify_lowered
from test_torch_lowering import (JAX, TORCH, TOL, D, chain_net, params_like,
                                 per_part_then_merge)


@dataclasses.dataclass
class Side:
    """One package's store, serde, verifier and data plumbing."""

    name: str
    pkg: object
    core: object
    store_mod: object
    serde: object
    verify_lowered: object

    def store(self, **kw):
        return self.store_mod.PlanStore(**kw)

    def open(self, path, **kw):
        return self.store_mod.PlanStore.open(str(path), **kw)

    def lower(self, g, plan):
        return self.store_mod.lower(g, plan, capture=False)

    def params(self, np_params):
        if self.name == "jax":
            return jax.tree_util.tree_map(jax.numpy.asarray, np_params)
        return params_from_numpy(np_params, device="cpu")

    def array(self, x):
        return jax.numpy.asarray(x) if self.name == "jax" \
            else torch.from_numpy(x)

    def interp(self, g, plan, params, x):
        return self.core.Realizer(g, plan, lowered=False)(params, {"x": x})


J = Side("jax", JAX, jcore, jstore, jserde, jverify_lowered)
T = Side("torch", TORCH, tcore, tstore, tserde, tverify_lowered)
SIDES = (J, T)
TIMING = {"lower_s", "specialize_s", "restore_s", "compile_s", "trace_s"}


def snap(store) -> dict:
    return {k: v for k, v in store.snapshot().items() if k not in TIMING}


def to_np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _np_data(n, B, seed):
    jnet = chain_net(JAX, n)
    np_params = params_like(jnet, seed)
    x = np.random.default_rng(seed + 1).standard_normal((B, D)).astype(
        np.float32)
    return np_params, x


def bucket(side, B, sizes, n=4, seed=0):
    """(graph, plan, params, x) of a ``n``-layer chain at batch ``B``,
    split into ``sizes`` with every op but the last per micro-batch and
    the last merged (unsplit, sequential, when ``sizes`` is empty)."""
    pkg = side.pkg
    net = chain_net(pkg, n)
    g = pkg.core.trace(net, {"x": pkg.spec((B, D), pkg.f32)})
    sched = per_part_then_merge(pkg, sizes) if sizes \
        else pkg.core.OpSchedulerBase()
    plan = pkg.core.record_plan(g, sched,
                                pkg.core.ScheduleContext(local_batch=B))
    np_params, x = _np_data(n, B, seed)
    return g, plan, side.params(np_params), side.array(x)


def served(side, lowered, g, plan, params, x) -> dict:
    """Run ``lowered``; it must equal the interpreter bitwise."""
    got = to_np(lowered(params, {"x": x}))
    want = to_np(side.interp(g, plan, params, x))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    return got


def both(scenario, *args):
    """Run ``scenario(side, *args)`` for each package; the observations
    (dicts) must be equal, except the ``"outputs"`` entry, which must
    agree within TOL."""
    obs = [scenario(side, *args) for side in SIDES]
    outs = [o.pop("outputs", []) for o in obs]
    assert obs[0] == obs[1]
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL)
    return obs[1]


# ---------------------------------------------------------------------------
# tests/test_plan_store.py: sharing, fingerprint v2, LRU
# ---------------------------------------------------------------------------


def test_cross_bucket_share_counters_and_differential():
    def scenario(side):
        store, outs, trail = side.store(), [], []
        for B, sizes in [(8, (4, 4)), (16, (8, 8)), (12, (4, 8))]:
            g, plan, params, x = bucket(side, B, sizes)
            lowered = store.get_or_lower(g, plan, salt="t", capture=False)
            outs.append(served(side, lowered, g, plan, params, x))
            trail.append(snap(store))
        s = store.stats
        assert (s["misses"], s["shares"], s["hits"]) == (1, 2, 0)
        assert store.share_rate == pytest.approx(2 / 3)
        g, plan, *_ = bucket(side, 8, (4, 4))
        store.get_or_lower(g, plan, salt="t", capture=False)
        assert store.stats["hits"] == 1
        trail.append(snap(store))
        return {"trail": trail, "outputs": outs}
    both(scenario)


def test_unsplit_plans_share_across_buckets():
    def scenario(side):
        store = side.store()
        for B in (4, 8, 32):
            g, plan, *_ = bucket(side, B, ())
            store.get_or_lower(g, plan, capture=False)
        assert (store.stats["misses"], store.stats["shares"]) == (1, 2)
        return {"snap": snap(store)}
    both(scenario)


def test_split_count_is_structural():
    def scenario(side):
        g1, p1, *_ = bucket(side, 8, (4, 4))
        g2, p2, *_ = bucket(side, 9, (3, 3, 3))
        store = side.store()
        store.get_or_lower(g1, p1, capture=False)
        store.get_or_lower(g2, p2, capture=False)
        s = store.stats
        assert (s["misses"], s["shares"], s["specialize_rejects"]) \
            == (2, 0, 0)
        return {"snap": snap(store)}
    both(scenario)


def test_specialize_fallback_is_counted(monkeypatch):
    def always_reject(*a, **k):
        raise jcore.LoweringError("forced drift")

    def reject_port(*a, **k):
        raise tcore.LoweringError("forced drift")
    monkeypatch.setattr(jstore, "specialize", always_reject)
    monkeypatch.setattr(tstore, "specialize", reject_port)

    def scenario(side):
        store = side.store()
        g1, p1, *_ = bucket(side, 8, (4, 4))
        store.get_or_lower(g1, p1, capture=False)
        g2, p2, params, x = bucket(side, 16, (8, 8))
        lowered = store.get_or_lower(g2, p2, capture=False)
        assert store.stats["specialize_rejects"] == 1
        assert store.stats["misses"] == 2
        return {"snap": snap(store),
                "outputs": [served(side, lowered, g2, p2, params, x)]}
    both(scenario)


def scaled_jax(info, x, factor=1.0):
    p = info.params_of(0)
    return jax.numpy.tanh(x @ p["w"]) * factor


def scaled_torch(info, x, factor=1.0):
    p = info.params_of(0)
    return torch.tanh(x @ p["w"]) * factor


SCALED = {"jax": scaled_jax, "torch": scaled_torch}


def fuse_first(side, fn):
    class FuseFirst(side.core.OpSchedulerBase):
        def schedule(self, ctx):
            oids = ctx.graph.topo_order()
            ctx.execute((side.core.OpHandle(oids[0], side.core.FULL, ""),),
                        replace_func=fn, replace_name="scaled")
            ctx.run_rest_sequential()
    return FuseFirst()


def fused_pair(side, fn, B=8, n=3):
    g = side.core.trace(chain_net(side.pkg, n),
                        {"x": side.pkg.spec((B, D), side.pkg.f32)})
    plan = side.core.record_plan(g, fuse_first(side, fn),
                                 side.core.ScheduleContext(local_batch=B))
    np_params, x = _np_data(n, B, 0)
    return g, plan, side.params(np_params), side.array(x)


def test_fused_closure_config_scopes_outer_key():
    def scenario(side):
        store, outs = side.store(), {}
        for factor in (2.0, 100.0):
            fn = functools.partial(SCALED[side.name], factor=factor)
            g, plan, params, x = fused_pair(side, fn)
            lowered = store.get_or_lower(g, plan, salt="FuseFirst",
                                         capture=False)
            outs[factor] = served(side, lowered, g, plan, params, x)
        s = store.stats
        assert (s["misses"], s["shares"], s["hits"]) == (2, 0, 0)
        assert not np.allclose(outs[2.0]["out"], outs[100.0]["out"])
        fn = functools.partial(SCALED[side.name], factor=2.0)
        g, plan, *_ = fused_pair(side, fn, B=16)
        store.get_or_lower(g, plan, salt="FuseFirst", capture=False)
        assert store.stats["shares"] == 1
        return {"snap": snap(store), "outputs": [outs[2.0], outs[100.0]]}
    both(scenario)


def test_op_config_and_salt_scope_outer_key():
    cfg_a = (("attn_impl", "xla"), ("tp", 1))
    cfg_b = (("attn_impl", "pallas"), ("tp", 1))

    def scenario(side):
        g1, p1, *_ = bucket(side, 8, (4, 4))
        g2, p2, *_ = bucket(side, 16, (8, 8))
        fp = side.store_mod.fingerprint_v2
        assert fp(g1, p1, op_config=cfg_a) != fp(g1, p1, op_config=cfg_b)
        assert fp(g1, p1, salt="a") != fp(g1, p1, salt="b")
        store = side.store()
        store.get_or_lower(g1, p1, op_config=cfg_a, capture=False)
        store.get_or_lower(g2, p2, op_config=cfg_b, capture=False)
        assert store.stats["misses"] == 2
        store.get_or_lower(g2, p2, op_config=cfg_a, capture=False)
        assert store.stats["shares"] == 1
        return {"snap": snap(store)}
    both(scenario)


def test_lru_eviction_under_byte_budget():
    def scenario(side):
        one = side.store_mod.plan_nbytes(
            side.lower(*bucket(side, 8, (4, 4))[:2]))
        store = side.store(plan_budget_bytes=int(one * 2.5))
        buckets = [(8, (4, 4)), (16, (8, 8)), (12, (4, 8)), (20, (10, 10)),
                   (24, (12, 12))]
        outs, trail = [], []
        for B, sizes in buckets:
            g, plan, params, x = bucket(side, B, sizes)
            lowered = store.get_or_lower(g, plan, capture=False)
            outs.append(served(side, lowered, g, plan, params, x))
            trail.append(snap(store))
        assert store.stats["evictions"] >= len(buckets) - 2
        assert store.n_plans <= 2
        assert store.stats["plan_bytes"] <= int(one * 2.5)
        assert store.stats["plan_bytes"] == sum(
            e[1] for e in store._plans.values())
        return {"one": one, "trail": trail, "outputs": outs}
    both(scenario)


def test_canonical_promotion_after_eviction():
    def scenario(side):
        store = side.store(plan_capacity=1)
        g1, p1, *_ = bucket(side, 8, (4, 4))
        g2, p2, *_ = bucket(side, 16, (8, 8))
        g3, p3, params, x = bucket(side, 12, (6, 6))
        store.get_or_lower(g1, p1, capture=False)
        store.get_or_lower(g2, p2, capture=False)
        assert store.stats["evictions"] == 1
        lowered = store.get_or_lower(g3, p3, capture=False)
        assert (store.stats["shares"], store.stats["misses"]) == (2, 1)
        return {"snap": snap(store),
                "outputs": [served(side, lowered, g3, p3, params, x)]}
    both(scenario)


def test_full_eviction_of_outer_entry_recovers():
    def scenario(side):
        store = side.store(plan_capacity=1)
        g1, p1, *_ = bucket(side, 8, (), n=2)
        store.get_or_lower(g1, p1, capture=False)
        g2, p2, *_ = bucket(side, 8, (4, 4))
        store.get_or_lower(g2, p2, capture=False)
        store.get_or_lower(g1, p1, capture=False)
        assert (store.stats["misses"], store.stats["shares"]) == (3, 0)
        return {"snap": snap(store)}
    both(scenario)


# ---------------------------------------------------------------------------
# tests/test_plan_persist.py: round trip, rejection, admission, format
# ---------------------------------------------------------------------------


def populate(side, buckets, salt="t"):
    store = side.store()
    pairs = [bucket(side, B, sizes) for B, sizes in buckets]
    for g, plan, _, _ in pairs:
        store.get_or_lower(g, plan, salt=salt, capture=False)
    return store, pairs


def entries(side, path) -> list:
    """The parsed entries of a saved store file."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    return [side.serde.parse_payload(ln.split(" ", 4)[4])
            for ln in lines[1:] if ln.startswith("E ")]


def test_round_trip_serves_all_buckets_without_lowering(tmp_path,
                                                        monkeypatch):
    def scenario(side):
        store, pairs = populate(side, [(8, (4, 4)), (16, (8, 8)),
                                       (12, (4, 8))])
        path = tmp_path / f"{side.name}.dfps"
        assert store.save(str(path)) == 1
        with monkeypatch.context() as mp:
            for s in SIDES:
                mp.setattr(s.store_mod, "lower", _bomb)
            warm = side.open(path)
            outs = [served(side, warm.get_or_lower(g, plan, salt="t",
                                                   capture=False),
                           g, plan, params, x)
                    for g, plan, params, x in pairs]
        s = warm.snapshot()
        assert s["misses"] == 0
        assert s["restore_hits"] + s["shares"] == len(pairs)
        assert s["restore_entries"] == 1
        return {"entries": entries(side, path), "bytes": path.read_bytes(),
                "saved": snap(store), "warm": snap(warm), "outputs": outs}
    both(scenario)


def _bomb(*a, **k):
    raise AssertionError("lower() called on a warm-started store")


def test_unseen_bucket_specializes_restored_canonical(tmp_path,
                                                      monkeypatch):
    def scenario(side):
        store, _ = populate(side, [(8, (4, 4))])
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        with monkeypatch.context() as mp:
            for s in SIDES:
                mp.setattr(s.store_mod, "lower", _bomb)
            warm = side.open(path)
            g, plan, params, x = bucket(side, 20, (10, 10))
            lowered = warm.get_or_lower(g, plan, salt="t", capture=False)
        out = served(side, lowered, g, plan, params, x)
        s = warm.stats
        assert (s["restore_canonicals"], s["shares"], s["misses"]) \
            == (1, 1, 0)
        return {"warm": snap(warm), "outputs": [out]}
    both(scenario)


def test_redeemed_then_evicted_entry_survives_checkpoint(tmp_path):
    def scenario(side):
        store, pairs = populate(side, [(8, (4, 4))])
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        warm = side.open(path, plan_capacity=1)
        g, plan, *_ = pairs[0]
        trail = []
        warm.get_or_lower(g, plan, salt="t", capture=False)
        trail.append(snap(warm))
        g2, p2, *_ = bucket(side, 8, (4, 4), n=2)
        warm.get_or_lower(g2, p2, salt="t", capture=False)
        trail.append(snap(warm))
        assert warm.stats["evictions"] == 1
        warm.get_or_lower(g, plan, salt="t", capture=False)
        assert warm.stats["restore_hits"] == 2
        assert warm.stats["misses"] == 1
        warm.get_or_lower(g2, p2, salt="t", capture=False)
        path2 = tmp_path / f"{side.name}2.dfps"
        assert warm.save(str(path2)) >= 1
        trail.append(snap(warm))
        warm2 = side.open(path2)
        warm2.get_or_lower(g, plan, salt="t", capture=False)
        assert (warm2.stats["restore_hits"], warm2.stats["misses"]) == (1, 0)
        return {"trail": trail, "warm2": snap(warm2),
                "entries": entries(side, path2)}
    both(scenario)


def test_checkpoint_skips_clean_store(tmp_path):
    def scenario(side):
        store, pairs = populate(side, [(8, (4, 4))])
        store.path = str(tmp_path / f"{side.name}.dfps")
        dirty = [store.dirty]
        store.save()
        dirty.append(store.dirty)
        g, plan, *_ = pairs[0]
        store.get_or_lower(g, plan, salt="t", capture=False)
        dirty.append(store.dirty)
        g2, p2, *_ = bucket(side, 24, (12, 12))
        store.get_or_lower(g2, p2, salt="t", capture=False)
        dirty.append(store.dirty)
        assert dirty == [True, False, False, True]
        return {"dirty": dirty}
    both(scenario)


def test_save_load_passthrough_preserves_unredeemed_entries(tmp_path):
    def scenario(side):
        store, pairs = populate(side, [(8, (4, 4))])
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        relay = side.open(path)
        path2 = tmp_path / f"{side.name}2.dfps"
        assert relay.save(str(path2)) == 1
        warm = side.open(path2)
        g, plan, *_ = pairs[0]
        warm.get_or_lower(g, plan, salt="t", capture=False)
        assert (warm.stats["restore_hits"], warm.stats["misses"]) == (1, 0)
        assert path.read_bytes() == path2.read_bytes()
        return {"relay": snap(relay), "warm": snap(warm)}
    both(scenario)


def saved_lines(side, tmp_path):
    store, pairs = populate(side, [(8, (4, 4))])
    path = tmp_path / f"{side.name}.dfps"
    store.save(str(path))
    return path.read_text(encoding="utf-8").splitlines(), pairs


def test_corrupt_entry_rejected_then_cold_lower(tmp_path):
    def scenario(side):
        lines, pairs = saved_lines(side, tmp_path)
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(lines[0] + "\n"
                       + lines[1].replace("reads", "rEAds", 1) + "\n",
                       encoding="utf-8")
        store = side.open(bad)
        opened = snap(store)
        assert store.stats["restore_rejected"] == 1
        g, plan, params, x = pairs[0]
        lowered = store.get_or_lower(g, plan, salt="t", capture=False)
        assert store.stats["misses"] == 1
        return {"opened": opened, "after": snap(store),
                "outputs": [served(side, lowered, g, plan, params, x)]}
    both(scenario)


@pytest.mark.parametrize("mutation", ["format", "fingerprint", "magic"])
def test_header_version_mismatch_rejects_file(tmp_path, mutation):
    def scenario(side):
        lines, _ = saved_lines(side, tmp_path)
        hdr = json.loads(lines[0])
        hdr.update({"format": {"format_version":
                               side.serde.FORMAT_VERSION + 1},
                    "fingerprint": {"fingerprint_version":
                                    side.core.FINGERPRINT_VERSION + 1},
                    "magic": {"magic": "not-a-planstore"}}[mutation])
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(json.dumps(hdr) + "\n" + lines[1] + "\n",
                       encoding="utf-8")
        store = side.open(bad)
        assert store.stats["restore_errors"] == 1
        assert store.n_restorable == 0
        return {"snap": snap(store)}
    both(scenario)


@pytest.mark.parametrize("body", ["", "complete garbage\n", "{}\n",
                                  '{"magic": 3}\n'],
                         ids=["empty", "garbage", "empty-object",
                              "bad-magic"])
def test_garbage_and_empty_files_rejected(tmp_path, body):
    def scenario(side):
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(body, encoding="utf-8")
        store = side.open(bad)
        assert store.stats["restore_errors"] == 1
        g, plan, *_ = bucket(side, 8, (4, 4))
        store.get_or_lower(g, plan, salt="t", capture=False)
        assert store.stats["misses"] == 1
        return {"snap": snap(store)}
    both(scenario)


def test_schema_malformed_entry_degrades_to_cold_lower(tmp_path):
    def scenario(side):
        lines, pairs = saved_lines(side, tmp_path)
        parts = lines[1].split(" ", 4)
        obj = json.loads(parts[4])
        del obj["buckets"][0]["instrs"]
        payload = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        check = hashlib.sha256(payload.encode()).hexdigest()[:16]
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(f"{lines[0]}\n{parts[0]} {parts[1]} {parts[2]} "
                       f"{check} {payload}\n", encoding="utf-8")
        store = side.open(bad)
        assert store.stats["restore_rejected"] == 0
        g, plan, params, x = pairs[0]
        lowered = store.get_or_lower(g, plan, salt="t", capture=False)
        assert store.stats["restore_rejected"] >= 1
        assert store.stats["misses"] == 1
        return {"snap": snap(store),
                "outputs": [served(side, lowered, g, plan, params, x)]}
    both(scenario)


def test_entry_version_mismatch_rejects_entry(tmp_path):
    def scenario(side):
        lines, _ = saved_lines(side, tmp_path)
        parts = lines[1].split(" ", 2)
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(f"{lines[0]}\n{parts[0]} "
                       f"{side.serde.FORMAT_VERSION + 1} {parts[2]}\n",
                       encoding="utf-8")
        store = side.open(bad)
        assert store.stats["restore_rejected"] == 1
        assert store.n_restorable == 0
        return {"snap": snap(store)}
    both(scenario)


def test_missing_file_is_empty_store_not_error(tmp_path):
    def scenario(side):
        store = side.open(tmp_path / "never-written.dfps")
        assert store.stats["restore_errors"] == 0
        assert store.n_restorable == 0
        return {"snap": snap(store)}
    both(scenario)


def test_save_is_deterministic_and_atomic(tmp_path):
    def scenario(side):
        store, _ = populate(side, [(8, (4, 4)), (16, (8, 8))])
        d = tmp_path / side.name
        d.mkdir()
        a, b = d / "a.dfps", d / "b.dfps"
        store.save(str(a))
        store.save(str(b))
        assert a.read_bytes() == b.read_bytes()
        assert [f for f in os.listdir(d) if f.startswith(".planstore")] \
            == []
        store.save(str(a))
        assert side.open(a).n_restorable == 1
        return {"entries": entries(side, a), "bytes": a.read_bytes()}
    both(scenario)


def test_opaque_closure_entries_not_persisted(tmp_path):
    def scenario(side):
        box = {"factor": 2.0}               # non-primitive closure cell
        tanh = side.pkg.tanh

        def scaled_box(info, x):
            p = info.params_of(0)
            return tanh(x @ p["w"]) * box["factor"]
        g, plan, *_ = fused_pair(side, scaled_box)
        store = side.store()
        store.get_or_lower(g, plan, salt="fuse", capture=False)
        assert store.save(str(tmp_path / f"{side.name}.dfps")) == 0
        assert store.stats["restore_skipped"] == 1
        return {"snap": snap(store)}
    both(scenario)


@pytest.mark.parametrize("key", [("fn", "mod", "qual"),
                                 (("closure", "m", "q", (1, b"x")), "s", ()),
                                 ("id", 140234), (("deep", ("id", 7)), "s")])
def test_persistable_key_marks_id_fallbacks(key):
    assert tserde.persistable_key(key) == jserde.persistable_key(key)
    assert tserde.key_digest(key) == jserde.key_digest(key)


def test_one_shot_eviction_not_readmitted(tmp_path):
    def scenario(side):
        def pair(n):
            return bucket(side, 8, (), n=n)[:2]
        store = side.store(plan_capacity=2)
        p1, p2, p3 = pair(2), pair(3), pair(4)
        for p in (p1, p2, p3):
            store.get_or_lower(*p, capture=False)
        assert store.stats["one_shot_evictions"] >= 1
        store.get_or_lower(*p1, capture=False)
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        hdr = json.loads(path.read_text(encoding="utf-8").splitlines()[0])
        assert len(hdr["one_shot"]) >= 1
        warm = side.open(path)
        warm.get_or_lower(*pair(2), capture=False)
        assert (warm.stats["restore_hits"], warm.stats["misses"]) == (0, 1)
        return {"store": snap(store), "warm": snap(warm),
                "one_shot": hdr["one_shot"]}
    both(scenario)


def test_touched_entries_are_persisted_under_churn():
    def scenario(side):
        store = side.store(plan_capacity=1)
        g1, p1, *_ = bucket(side, 8, (4, 4))
        g2, p2, *_ = bucket(side, 16, (8, 8))
        store.get_or_lower(g1, p1, capture=False)
        store.get_or_lower(g2, p2, capture=False)
        assert store.stats["evictions"] == 1
        assert store.stats["one_shot_evictions"] == 0
        return {"snap": snap(store)}
    both(scenario)


# ---------------------------------------------------------------------------
# the executable level
# ---------------------------------------------------------------------------


def test_key_for_accepts_tensors_and_scalars_only():
    inputs = {"x": np.zeros((2, 3), np.float32), "n": 7, "flag": True,
              "name": "bucket"}
    want = jstore.PlanStore().key_for("fp", inputs)
    port = tstore.PlanStore()
    assert port.key_for("fp", inputs) == want
    assert port.key_for("fp", {**inputs, "x": torch.zeros(
        (2, 3), dtype=torch.float32)}) == want
    for bad in ([1, 2, 3], object()):
        with pytest.raises(TypeError, match="neither an array"):
            port.key_for("fp", {"bad": bad})


def test_exec_byte_budget_evicts_lru():
    def scenario(side):
        store = side.store(exec_capacity=100, exec_budget_bytes=3 * 4096)
        for i in range(5):
            store.get_or_build(("k", i), lambda i=i: (lambda: i))
        assert store.n_execs <= 3
        assert store.stats["exec_evictions"] >= 2
        assert store.stats["exec_bytes"] == sum(
            nb for _, nb in store._execs.values())
        assert ("k", 4) in store._execs and ("k", 0) not in store._execs
        return {"snap": snap(store), "keys": list(store._execs)}
    both(scenario)


def test_snapshot_exec_symmetry():
    def scenario(side):
        store = side.store()
        store.get_or_build(("a",), lambda: (lambda: 1))
        store.get_or_build(("a",), lambda: (lambda: 1))
        assert store.snapshot()["exec_hit_rate"] == 0.5
        return {"snap": snap(store)}
    both(scenario)


class _Captured:
    """What a ``GraphStep`` shows the store: its capture time and the
    bytes it took from the graph pool."""

    def __init__(self, nbytes):
        self.capture_s, self.nbytes = 0.25, nbytes


def test_exec_level_accounts_captures_and_evicts_them():
    """The port's exec level holds CUDA Graphs: a built object with
    ``capture_s`` and ``nbytes`` counts its capture under ``compile_s``
    and its pool bytes under ``exec_bytes``; ``evict_execs`` drops what
    a predicate matches (an engine's graphs), counted as evictions."""
    store = tstore.PlanStore(exec_capacity=8)
    store.get_or_build(("decode", ("engine", 1), 4),
                       lambda: _Captured(1 << 20))
    store.get_or_build(("prefill", ("engine", 1), 4, 2048),
                       lambda: _Captured(0))
    store.get_or_build(("decode", ("engine", 2), 4), lambda: _Captured(4096))
    s = store.stats
    assert s["compile_s"] == pytest.approx(0.75)
    assert s["exec_bytes"] == (1 << 20) + 4096 + 4096   # 0 takes the floor
    assert store.evict_execs(lambda k: k[1] == ("engine", 1)) == 2
    assert (store.n_execs, s["exec_evictions"], s["exec_bytes"]) \
        == (1, 2, 4096)


def test_digest_is_stable_across_key_copies():
    k = (("a", (1, 2)), "s", ())
    assert tserde.key_digest(k) == tserde.key_digest((("a", (1, 2)), "s", ()))
    assert tserde.key_digest(k) == jserde.key_digest(k)


# ---------------------------------------------------------------------------
# verify_lowered (tests/test_verify.py's layer 2) on both packages
# ---------------------------------------------------------------------------


def with_instr(low, i, **attrs):
    instrs = list(low.instrs)
    mut = copy.copy(instrs[i])
    for k, v in attrs.items():
        setattr(mut, k, v)
    instrs[i] = mut
    return dataclasses.replace(low, instrs=tuple(instrs))


def codes(side, low) -> list:
    return [(d.severity, d.code, d.step_index)
            for d in side.verify_lowered(low)]


def _invalid_slot(low):
    i = next(j for j, ins in enumerate(low.instrs) if ins.reads)
    ins = low.instrs[i]
    return with_instr(low, i, reads=((low.n_slots + 3, ins.reads[0][1]),)
                      + tuple(ins.reads[1:]))


def _use_after_death(low):
    i = max(j for j, ins in enumerate(low.instrs) if ins.reads)
    slot = low.instrs[i].reads[0][0]
    return with_instr(low, i - 1,
                      frees=tuple(low.instrs[i - 1].frees) + (slot,))


def _clobber(low):
    x_slot = low.input_slots[0][1]
    (_w, buf0), *rest = low.instrs[0].writes
    return with_instr(low, 0, writes=((x_slot, buf0),) + tuple(rest))


def _no_buffer_write(low):
    i = next(j for j, ins in enumerate(low.instrs)
             if any(b is not None for _s, b in ins.writes))
    return with_instr(low, i, writes=tuple((s, None)
                                           for s, _b in low.instrs[i].writes))


def _double_create(low):
    """A later producer re-creates the merge buffer (its write gets the
    first producer's pad layout)."""
    idx = [j for j, ins in enumerate(low.instrs)
           if any(b is not None for _s, b in ins.writes)]
    first = low.instrs[idx[0]].writes[0][1]
    i = idx[1]
    (slot, buf), *rest = low.instrs[i].writes
    return with_instr(low, i, writes=((slot, (buf[0], None, first[2],
                                              first[3])),) + tuple(rest))


def _short(low):
    return dataclasses.replace(low, instrs=low.instrs[:-1])


TAMPER = {"invalid_slot": _invalid_slot, "use_after_death": _use_after_death,
          "clobber": _clobber, "no_buffer_write": _no_buffer_write,
          "double_create": _double_create, "metadata": _short}


@pytest.mark.parametrize("how", ["fresh", "specialized", "rehydrated"]
                         + sorted(TAMPER))
def test_verify_lowered_codes_match(tmp_path, how):
    def scenario(side):
        g, plan, *_ = bucket(side, 8, (4, 4))
        low = side.lower(g, plan)
        if how == "specialized":
            g2, p2, *_ = bucket(side, 16, (6, 10))
            low = side.store_mod.specialize(low, g2, p2, capture=False)
        elif how == "rehydrated":
            store = side.store()
            store.get_or_lower(g, plan, salt="t", capture=False)
            path = tmp_path / f"{side.name}.dfps"
            store.save(str(path))
            low = side.open(path, verify_restored=False).get_or_lower(
                g, plan, salt="t", capture=False)
            assert low.stats["restored"] == 1
        elif how in TAMPER:
            low = TAMPER[how](low)
        got = codes(side, low)
        assert bool(got) == (how in TAMPER)
        return {"codes": got}
    obs = both(scenario)
    want = {"invalid_slot": {"VFY101"}, "use_after_death": {"VFY101",
                                                            "VFY104"},
            "clobber": {"VFY102"}, "no_buffer_write": {"VFY103"},
            "double_create": {"VFY103"}, "metadata": {"VFY105"}}
    assert {c for _s, c, _i in obs["codes"]} >= want.get(how, set())


def test_tampered_artifact_rejected_by_semantic_verify(tmp_path):
    def scenario(side):
        g, plan, params, x = bucket(side, 8, (4, 4))
        store = side.store()
        store.get_or_lower(g, plan, salt="t", capture=False)
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        lines = path.read_text(encoding="utf-8").splitlines()
        head, ver, fp2, _check, payload = lines[1].split(" ", 4)
        obj = json.loads(payload)
        instrs = obj["buckets"][0]["instrs"]
        li = max(i for i, ins in enumerate(instrs) if ins[0])
        instrs[li - 1][2] = list(instrs[li - 1][2]) + [instrs[li][0][0][0]]
        payload = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        check = hashlib.sha256(payload.encode()).hexdigest()[:16]
        bad = tmp_path / f"{side.name}-bad.dfps"
        bad.write_text(f"{lines[0]}\n{head} {ver} {fp2} {check} {payload}\n",
                       encoding="utf-8")
        blind = side.open(bad, verify_restored=False)
        blind.get_or_lower(g, plan, salt="t", capture=False)
        assert blind.stats["restore_hits"] == 1
        assert blind.stats["restore_verify_rejected"] == 0
        warm = side.open(bad)
        assert warm.stats["restore_rejected"] == 0
        lowered = warm.get_or_lower(g, plan, salt="t", capture=False)
        assert warm.stats["restore_verify_rejected"] >= 1
        assert warm.stats["restore_rejected"] >= 1
        assert warm.stats["misses"] == 1
        return {"blind": snap(blind), "warm": snap(warm),
                "outputs": [served(side, lowered, g, plan, params, x)]}
    both(scenario)


# ---------------------------------------------------------------------------
# the port's own: dtype names, the capture flag, a model's segments
# ---------------------------------------------------------------------------


def test_bucket_key_names_dtypes_as_the_reference_does():
    (jg, jp, *_), (tg, tp, *_) = (bucket(J, 8, (4, 4)), bucket(T, 8, (4, 4)))
    assert tstore.bucket_key(tg, tp, False) == jstore.bucket_key(jg, jp,
                                                                 False)
    assert tstore.bucket_key(tg, tp, True) != tstore.bucket_key(tg, tp)


def test_capture_flag_is_its_own_bucket_and_persists(tmp_path):
    g, plan, *_ = bucket(T, 8, (4, 4))
    store = tstore.PlanStore()
    eager = store.get_or_lower(g, plan, salt="t")
    graphed = store.get_or_lower(g, plan, salt="t", capture=True)
    assert (eager.capture, graphed.capture) == (False, True)
    assert (store.stats["misses"], store.stats["shares"]) == (1, 1)
    path = tmp_path / "store.dfps"
    store.save(str(path))
    assert [e["buckets"][0]["capture"] for e in entries(T, path)] == [False]


def test_model_segments_restore_with_zero_lowers(tmp_path, monkeypatch):
    """A smoke model's prefill and decode segments, built through a store,
    saved and built again through the opened store: every segment is
    restored or shared, none lowered, and the steps agree bitwise."""
    from repro_torch.api import compile as tcompile
    prog = tcompile("deepseek-moe-16b", smoke=True, device="cpu")
    params = prog.init_params(0)
    tiers = prog.decode_tiers(4, 32)
    step = prog.prefill(2, 16)
    path = tmp_path / "moe.dfps"
    assert prog.store.save(str(path)) == prog.store.stats["misses"] > 0
    monkeypatch.setattr(tstore, "lower", _bomb)
    warm = tcompile("deepseek-moe-16b", smoke=True, device="cpu",
                    plan_store_path=str(path))
    wtiers = warm.decode_tiers(4, 32)
    wstep = warm.prefill(2, 16)
    s = warm.stats
    assert s["misses"] == 0 and s["restore_hits"] > 0
    assert s["restore_hits"] + s["shares"] == prog.store.stats["misses"] \
        + prog.store.stats["shares"]
    ids = torch.randint(0, prog.model.cfg.vocab, (2, 16),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    a = step(params, {"ids": ids, "positions": pos})["logits"]
    b = wstep(params, {"ids": ids, "positions": pos})["logits"]
    assert torch.equal(a, b)
    assert set(tiers) == set(wtiers) == {1, 2, 4}


def test_program_closes_into_its_store_and_refuses_bad_bundles(tmp_path):
    """``with compile(..., plan_store_path=p)`` checkpoints ``p`` on exit;
    ``Program.load`` refuses a bundle of another magic or version, and
    one saved with an opaque policy unless ``policy=`` is given."""
    from repro_torch.api import Program, ProgramBundleError
    from repro_torch.api import compile as tcompile
    from repro_torch.core.strategies.nanoflow import NanoFlow
    path = tmp_path / "plans.dfps"
    with tcompile("smollm-135m", smoke=True, device="cpu",
                  plan_store_path=str(path)) as prog:
        prog.prefill(2, 16)
        assert prog.stats["misses"] > 0
    assert tstore.PlanStore.open(str(path)).n_restorable \
        == prog.stats["misses"]
    bundle = tmp_path / "p.dfpb"
    prog.save(str(bundle))
    assert Program.load(str(bundle), device="cpu").policy_spec == "<default>"
    head, body = bundle.read_text().split("\n", 1)
    for field, bad in (("magic", "other"), ("format_version", 99),
                       ("fingerprint_version", 99),
                       ("plan_format_version", 99),
                       ("cache_backend", ["bogus"])):
        hdr = json.loads(head)
        hdr[field] = bad
        wrong = tmp_path / f"{field}.dfpb"
        wrong.write_text(json.dumps(hdr) + "\n" + body)
        with pytest.raises(ProgramBundleError):
            Program.load(str(wrong), device="cpu")
    opaque = tcompile("smollm-135m", smoke=True, device="cpu",
                      policy=NanoFlow())
    opaque.save(str(bundle))
    with pytest.raises(ProgramBundleError, match="opaque policy"):
        Program.load(str(bundle), device="cpu")
    assert Program.load(str(bundle), policy=NanoFlow(), device="cpu") \
        .policy_spec is None

