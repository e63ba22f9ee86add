#!/usr/bin/env python3
"""Probes of the port's decode attention, RMSNorm and SSD kernels on one GPU.

  decode   builds a copy of ``csrc/decode_attention.cu`` whose blocks
           stamp ``%globaltimer`` at each phase (entry, cache_len read,
           first tile landed, keys computed, partials written, merger
           chosen, merge data landed, merged once, merged twice), runs it
           at the kernels phase's three decode cases on cold caches, and
           prints for each phase the stamps' count, min, median and max in
           microseconds after the first block's entry, with the stamped
           kernel's device time
  rmsnorm  times the RMSNorm kernel at each number of warps a row it
           takes (1, 2, 4) at the kernels phase's cases, beside
           ``F.rms_norm`` (torch.profiler kernel durations, in turns)
  ssd      builds ``csrc/ssd_scan.cu``, a copy of it in which each warp
           sums its ``clock64`` cycles per phase of a task (``SSD_PHASES``:
           tiles landed, top barrier, cumsum and C fragments, y, state
           update, end barrier and the state's parts) and, for each ``--ssd-other NAME=DIR``, the
           ``ssd_scan.cu`` in DIR (another tree's csrc directory, such as
           the parent commit's); holds each against the plain
           version at the kernels phase's SSD cases, times them in turns
           (device time alone) and prints each warp's mean cycles a block
           per phase, with ptxas's registers and spills of each build

Usage:  python3 tools/kernel_probes.py [--probes decode,rmsnorm,ssd]
            [--ssd-other NAME=DIR ...]
Needs a CUDA device and nvcc; prints one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (phase, anchor in decode_attention.cu, where the stamp goes): after the
# anchor unless the phase name starts with "<"
STAMPS = [
    ("<entry", "  const int c = blockIdx.x, pair = blockIdx.y;\n"),
    ("cache_len read", "  if (c >= max(n_act, 1)) return;          // past the row's end\n"),
    ("first tile landed",
     "      mbar_wait(&sh.bar[u % n_stages][warp], (u / n_stages) & 1);\n"),
    ("<keys computed", "    // merge the warps' (m, l, O) in warp order\n"),
    ("<partials written", "  if (n_act == 1) return;\n\n  // Two-level merge"),
    ("merger chosen", "  if (!arrive_last(cnt + grp, members, sh)) return;\n"),
    ("merge data landed", "    mbar_wait(&sh.merge_bar, phase);\n    phase ^= 1;\n    __syncthreads();\n"),
    ("<merged once", "  if (n_grp == 1) return;\n  if (!arrive_last(cnt + MAX_GROUPS"),
    ("merged twice", "                     true, buf, phase);\n"),
]
PRELUDE = r'''
__device__ unsigned long long g_stamps[16384][16];
#define STAMP(k) do { if (threadIdx.x == 0) { unsigned long long t_;            \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) :: "memory");           \
  g_stamps[blockIdx.y * gridDim.x + blockIdx.x][k] = t_; } } while (0)
'''
EPILOGUE = r'''
extern "C" int probe_stamps(void* host, int n, int clear) {
  static unsigned long long zero[16384][16];
  if (clear) return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * 16 * 8);
}
'''


def stamped_source() -> str:
    """decode_attention.cu with a STAMP(k) at each phase of ``STAMPS`` (a
    block of several tiles, head tiles or merges keeps its last stamp)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "decode_attention.cu").read_text()
    src = src.replace('#include "hopper.cuh"\n',
                      '#include "hopper.cuh"\n' + PRELUDE, 1)
    for k, (name, anchor) in enumerate(STAMPS):
        if anchor not in src:
            raise RuntimeError(f"stamp anchor of {name!r} not found")
        stamp = f"  STAMP({k});\n"
        if name.startswith("<"):
            src = src.replace(anchor, stamp + anchor, 1)
        else:
            src = src.replace(anchor, anchor + stamp, 1)
    return src + EPILOGUE


def probe_decode(out):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    import chip_smoke as cs
    tmp = tempfile.mkdtemp()
    cu = os.path.join(tmp, "decode_stamped.cu")
    with open(cu, "w") as f:
        f.write(stamped_source())
    so = os.path.join(tmp, "decode_stamped.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-shared", cu, "-o", so],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    for name, (args, res) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    names = [n.lstrip("<") for n, _ in STAMPS]
    for what, H, Hk in (("chatglm3-6b", 32, 2), ("zamba2-1.2b", 32, 32),
                        ("deepseek-moe-16b", 16, 16)):
        B, S, hd, lens = 4, 4096, 128, (4096, 2999, 1500, 17)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = 4 * sum(lens) * Hk * hd
        sets = [(randn(B, 1, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd))
                for _ in range(max(2, -(-100_000_000 // valid)))]
        saved, _build._LIB = _build._LIB, lib
        try:
            for a in sets:
                dec.decode_attention(*a, clen, kv_head=kvh)
            torch.cuda.synchronize()
            lib.probe_stamps(None, 0, 1)
            dec.decode_attention(*sets[1], clen, kv_head=kvh)
            torch.cuda.synchronize()
            geo = dec.decode_geometry(B, S, H, Hk, hd)
            nb = geo["grid"][0] * geo["grid"][1]
            buf = (ctypes.c_ulonglong * (nb * 16))()
            lib.probe_stamps(buf, nb, 0)
            ms = cs.device_ms([lambda a=a: dec.decode_attention(
                *a, clen, kv_head=kvh) for a in sets])
        finally:
            _build._LIB = saved
        rows = [[buf[i * 16 + k] for k in range(len(names))]
                for i in range(nb)]
        t0 = min(r[0] for r in rows if r[0])
        phases = {}
        for k, name in enumerate(names):
            v = sorted((r[k] - t0) / 1e3 for r in rows if r[k])
            if v:
                phases[name] = {"blocks": len(v), "min_us": v[0],
                                "median_us": v[len(v) // 2],
                                "max_us": v[-1]}
        out({"probe": "decode", "case": f"{what} decode: B={B} S={S} "
             f"H={H} Hkv={Hk} cache_len={list(lens)}", "chunk": geo["chunk"],
             "group": geo["group"], "stamped_device_ms": ms,
             "phases": phases})


def probe_rmsnorm(out):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    import chip_smoke as cs
    lib = _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for n, d in ((4096, 4096), (8192, 2560), (8192, 2048), (8192, 4096),
                 (4, 4096)):
        x = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
        o = torch.empty_like(x)
        fns = {"F.rms_norm": lambda: F.rms_norm(x, (d,), w, rn.EPS)}
        for wpr in (1, 2, 4):
            packs = [p for p in rn.NORM_PACKS if 256 * wpr * p >= d]
            if packs:
                fns[f"{wpr} warps x {packs[0]} packs"] = (
                    lambda wpr=wpr, p=packs[0]: _build.check(
                        lib.repro_rmsnorm_fwd(
                            x.data_ptr(), w.data_ptr(), o.data_ptr(), n, d,
                            d, d, 0, 0, wpr, p, rn.EPS,
                            torch.cuda.current_stream().cuda_stream),
                        "rmsnorm"))
        times: dict = {}
        for k in list(fns) + list(fns)[::-1]:
            times.setdefault(k, []).append(cs.device_ms([fns[k]]))
        out({"probe": "rmsnorm", "case": f"n={n} d={d} bf16",
             "device_ms_turns": times})


# (phase, anchor in ssd_scan.cu, where the mark goes): each warp adds the
# clock64 cycles since its previous mark to the phase's sum ("<": before
# the anchor, else after it)
SSD_PHASES = [
    ("<init", "  for (int it = 0; it < len; ++it) {\n"),
    ("tiles landed", "    mbar_wait(&bar[st], (it >> 1) & 1);\n"),
    ("top barrier",
     "    __syncthreads();  // the tiles landed; the state's parts written"),
    ("<cumsum, C fragments", "    // ---- y = exp(cum) C S + M x + D x"),
    ("<y", "    // ---- S = exp(cum_Q) S + (w o B)^T x"),
    ("<state update", "    // ---- the state: on to the next block"),
    ("end barrier, state parts", "    if (goes_on) write_parts(sacc);\n"),
]
SSD_PRELUDE = r'''
__device__ long long g_ph[16384][8];
#define PH_INIT long long ph_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long ph_t = clock64();
#define PH(k) do { const long long t_ = clock64(); ph_acc[k] += t_ - ph_t; \
  ph_t = t_; } while (0)
'''
SSD_EPILOGUE = r'''
extern "C" int probe_phases(void* host, int n) {
  static long long zero[16384][8];
  if (host == nullptr) return (int)cudaMemcpyToSymbol(g_ph, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_ph, (size_t)n * 8 * 8 * 8);
}
'''


def ssd_phase_source(csrc) -> str:
    """``csrc``'s ssd_scan.cu with each warp's cycles summed per phase of
    ``SSD_PHASES`` and written to ``g_ph[block * 8 + warp]`` at the end."""
    src = open(os.path.join(csrc, "ssd_scan.cu")).read()
    src = src.replace('#include "hopper.cuh"\n',
                      '#include "hopper.cuh"\n' + SSD_PRELUDE, 1)
    for k, (name, anchor) in enumerate(SSD_PHASES):
        if anchor not in src:
            raise RuntimeError(f"phase anchor of {name!r} not found")
        mark = "  PH_INIT\n" if k == 0 else f"    PH({k - 1});\n"
        if name.startswith("<"):
            src = src.replace(anchor, mark + anchor, 1)
        else:
            i = src.index(anchor) + len(anchor)
            i = src.index("\n", i - 1) + 1 if not anchor.endswith("\n") \
                else i
            src = src[:i] + mark + src[i:]
    done = ("  if ((threadIdx.x & 31) == 0)\n"
            "    for (int k_ = 0; k_ < 8; ++k_)\n"
            "      g_ph[(blockIdx.y * gridDim.x + blockIdx.x) * 8 +\n"
            "           (threadIdx.x >> 5)][k_] = ph_acc[k_];\n")
    end = "  }\n}\n\ntemplate <int N>\nint launch_ssd"
    if end not in src:
        raise RuntimeError("kernel end not found")
    src = src.replace(end, "  }\n" + done + "}\n\ntemplate <int N>\n"
                      "int launch_ssd", 1)
    return src + SSD_EPILOGUE


class _NoWorkspace:
    """A library whose SSD kernel predates the workspace argument (an
    older tree's): the wrapper's call without it."""

    def __init__(self, lib):
        self._lib = lib
        fn = lib.repro_ssd_scan_fwd
        fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def repro_ssd_scan_fwd(self, *args):
        return self._lib.repro_ssd_scan_fwd(*args[:-2], args[-1])


def _load_lib(so, src=None):
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(so)
    for name, (args, res) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    if src and "void* work" not in open(src).read():
        return _NoWorkspace(lib)
    return lib


def probe_ssd(out, others=()):
    """This tree's SSD kernel (and each of ``others``, NAME=DIR) held to
    the plain version and timed in turns at the kernels phase's SSD
    cases; then a copy that sums each warp's cycles per phase."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    import chip_smoke as cs
    tmp = tempfile.mkdtemp()
    staged = os.path.join(tmp, "ssd_phases.cu")
    with open(staged, "w") as f:
        f.write(ssd_phase_source(str(_build.CSRC)))
    srcs = {"this tree": os.path.join(str(_build.CSRC), "ssd_scan.cu"),
            "phases": staged}
    for other in others:
        name, d = other.split("=", 1)
        srcs[name] = os.path.join(os.path.abspath(d), "ssd_scan.cu")
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", src, "-o", os.path.join(tmp, f"ssd{i}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (k, src) in enumerate(srcs.items())}
    libs, builds = {}, {}
    for i, (k, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {k}:\n{log}")
        builds[k] = cs.ptxas_report(log, ("ssd_scan_kernel",))
        libs[k] = _load_lib(os.path.join(tmp, f"ssd{i}.so"), srcs[k])
    libs["phases"].probe_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out({"probe": "ssd", "builds": builds})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    names = [n.lstrip("<") for n, _ in SSD_PHASES[1:]]
    saved = _build._LIB
    try:
        for what, b, H, N in (("mamba2-2.7b prefill", 4, 80, 128),
                              ("mamba2-2.7b NanoFlow half", 2, 80, 128),
                              ("zamba2-1.2b NanoFlow half", 2, 64, 64)):
            args = cs.ssd_inputs(g, b, 2048, H, 64, N)
            ref = ssd.ssd_scan_plain(*args)
            fns, checks, outs = {}, {}, {}
            for k, lib in libs.items():
                _build._LIB = lib
                got = outs[k] = ssd.ssd_scan(*args)
                torch.cuda.synchronize()
                checks[k] = cs.compare("ssd_scan", [(got, ref)])
                fns[k] = lambda lib=lib: (
                    setattr(_build, "_LIB", lib), ssd.ssd_scan(*args))
            times: dict = {}
            for k in list(fns) + list(fns)[::-1]:
                times.setdefault(k, []).append(cs.device_ms([fns[k]]))
            # every build again after the timed calls: the same output
            again = {}
            for k, lib in libs.items():
                _build._LIB = lib
                again[k] = bool(torch.equal(ssd.ssd_scan(*args), outs[k]))
            _build._LIB = libs["phases"]
            libs["phases"].probe_phases(None, 0)
            ssd.ssd_scan(*args)
            torch.cuda.synchronize()
            nb = torch.cuda.get_device_properties(dev).multi_processor_count
            tasks = b * H * (2048 // ssd.chunk_len(2048, 128))
            buf = (ctypes.c_longlong * (nb * 64))()
            libs["phases"].probe_phases(buf, nb)
            # mean cycles a task per phase, for each warp
            per_warp = {w: {n: sum(buf[(blk * 8 + w) * 8 + k]
                                   for blk in range(nb)) / tasks
                            for k, n in enumerate(names)}
                        for w in range(8)}
            out({"probe": "ssd", "case": f"{what}: b={b} L=2048 H={H} "
                 f"P=64 G=1 N={N}", "checks": checks,
                 "device_ms_turns": times, "same_output_again": again,
                 "cycles_per_task": per_warp})
    finally:
        _build._LIB = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probes", default="decode,rmsnorm,ssd")
    ap.add_argument("--ssd-other", action="append", default=[],
                    help="NAME=DIR: the ssd_scan.cu of another tree's "
                         "kernels/csrc directory, timed beside this one's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: no CUDA device", file=sys.stderr)
        return 2

    def out(obj):
        print(json.dumps(obj), flush=True)

    probes = set(args.probes.split(","))
    if "decode" in probes:
        probe_decode(out)
    if "rmsnorm" in probes:
        probe_rmsnorm(out)
    if "ssd" in probes:
        probe_ssd(out, args.ssd_other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
