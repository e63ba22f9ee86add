"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  The cell's file (``bench/workloads/<cell>.json``) names its
configuration, its traffic mix, its chips and its driver; the metrics it
reports are those ``BENCHMARK.json`` lists for it: the end-to-end ones
with ``--trace 0``, the per-layer ones with ``--trace 1``, each read by
its own reader under ``bench/metrics/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, every number the run compared beside
its limit, which also close standard error.  Without a card, with fewer
cards than the cell asks for, or when the JAX package was loaded, the run
prints no result and exits with a code other than 0.
"""
import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench", ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start() -> float:
    """Seconds from this process's start to now, from /proc (ticks of
    10 ms); 0 where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are the JAX package or JAX,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def read_metrics(catalog, cell: str, table: str, ctx: dict) -> dict:
    out = {}
    for m in catalog.metrics_of(cell, table):
        v = catalog.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, control: bool = False) -> int:
    args = parse(argv)
    args.control = control
    born = _since_process_start()
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.harness import catalog
    cell = catalog.workload(args.workload)
    cfg = catalog.config(cell["config"])
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.makedirs(CACHE, exist_ok=True)
    args.plan_store = os.path.join(CACHE, f"{cell['config']}.plans")
    t_start = T_TOP - born
    res = catalog.driver(cell["driver"]).run(cell, cfg, args, device,
                                             t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of the JAX package or JAX: {found}",
              file=sys.stderr)
        return 3
    ctx = res["ctx"]
    table = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(catalog, cell["name"], table, ctx)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"], "memory_peak_bytes": int(res["peak"]),
           "power_limit_w": _power_limit_w()}
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    tr = ctx.get("trace")
    if args.trace:
        if tr is None:
            print("the traced window holds no device operation",
                  file=sys.stderr)
            return 4
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["info"] = res["info"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in res["checks"]}
    for name, v, lim in res["checks"]:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
