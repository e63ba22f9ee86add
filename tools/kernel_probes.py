#!/usr/bin/env python3
"""Probes of the port's decode attention, norm and SSD kernels on one GPU.

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
  fused    times the fused add+RMSNorm kernel at the kernels phase's two
           TokenWeave cases (4096 and 8192 rows of 4096 bf16) over a sweep
           of block counts (``FUSED_CTAS``, by ``block_rows``) and, at
           TokenWeave's 256 rows a block, of consumer warps, warps a row
           and ring stages, beside the ``torch.add`` + ``F.rms_norm``
           composition and, for each ``--fused-other NAME=DIR``, the fused
           kernel of the tree at DIR (a checkout's root, such as the
           parent commit unpacked; its ``src/repro_torch`` is imported
           under another name); each held to the plain version, this
           tree's outputs bitwise equal wherever a row has the same warps,
           all timed in turns (device time alone), with the bytes a busy
           SM moves per microsecond; then copies without the kernel's
           stores, its loads or both in turns with it, and each warp's
           ``clock64`` cycles a row per bucket (``FUSED_MARKS``)
  norm_bwd times the RMSNorm backward and the fused add+RMSNorm backward
           at the train step's two shapes (16384 x 576, 4096 x 4096) over
           a sweep of grids, 1 to 6 blocks an SM, and copies of the kernel
           whose row loads, stores or both carry cache-streaming hints, each
           held to its plain version, in turns (device time alone, both
           launches), with each pass's device time at the wrapper's grid
           and the instantiation's registers and blocks resident an SM

  ssd_bwd  builds ``csrc/ssd_scan_bwd.cu`` and, for each ``--ssd-bwd-other
           NAME=DIR``, the ``ssd_scan_bwd.cu`` in DIR (another tree's
           csrc directory, such as the parent commit's; one that predates
           the head-set argument is called with its own per-head
           workspace); holds each against ``ssd_scan_bwd_plain`` and
           itself at the train step's two shapes (mamba2-2.7b's and
           zamba2-1.2b's NanoFlow halves), times them in turns (device
           time alone, this tree between the others' turns), with each
           launch's device ms and ptxas's registers and spills

Usage:  python3 tools/kernel_probes.py
            [--probes decode,rmsnorm,ssd,fused,norm_bwd,ssd_bwd]
            [--ssd-other NAME=DIR ...] [--fused-other NAME=DIR ...]
            [--ssd-bwd-other NAME=DIR ...]
Needs a CUDA device and nvcc; prints one JSON line per case.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
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


SSD_BWD_PASSES = ("ssd_bwd_states", "ssd_bwd_walk", "ssd_bwd_chunk",
                  "ssd_bwd_reduce")
# (phase, anchor in ssd_scan_bwd.cu's chunk pass, where the mark goes), as
# SSD_PHASES: each warp's clock64 cycles a task (a head's phase I or J)
SSD_BWD_PHASES = [
    ("<init", "  for (int it = 0; it < 2 * nh; ++it) {\n"),
    ("<next task's loads issued", "    const float last = warp_scan("),
    ("cumsum", "    const float last = warp_scan(dcur, Ah, Q, lane, cw, wdt, "
               "ww);\n"),
    ("<warp 0's global reads", "    mbar_wait(&bar[st], (it >> 1) & 1);\n\n"),
    ("tiles landed", "    mbar_wait(&bar[st], (it >> 1) & 1);\n\n"),
    ("<I: state terms", "      // the triangle's tiles j <= i\n"),
    ("<I: triangle", "      rk0 = quad_sum(rk0);\n"),
    ("<J: state terms", "      // the triangle's tiles i >= j, from the "
                        "transposes"),
    ("<J: triangle", "      // dx + D dy, rounded once\n"),
    ("<rows out", "    if (it == nh - 1) {   // the unit's dC is complete"),
    ("dC out, end barrier", "J's rows written\n"),
    ("warp 0's dcum", "        a.ws_pd[chain * a.nc + un.n] = gs;\n"
                      "      }\n    }\n"),
]


def _ssd_bwd_caller(lib, src):
    """A call of ``lib``'s backward on (x, dt, A, B, C, D, dy) as the
    wrapper makes it: this tree's through ``ssd_scan_bwd`` itself, a tree
    without the head-set argument with its per-head workspace."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    if "int sets" in open(src).read():
        def call(*args):
            _build._LIB = lib
            return ssd.ssd_scan_bwd(*args)
        return call
    fn = lib.repro_ssd_scan_bwd
    sig = list(_build._SIGNATURES["repro_ssd_scan_bwd"][0])
    fn.argtypes = sig[:20] + sig[21:]
    fn.restype = ctypes.c_int

    def call(x, dt, A, B, C, D, dy):
        b, L, H, P = x.shape
        G, N = B.shape[2], B.shape[3]
        Q = ssd.chunk_len(L, 128)
        nc = L // Q
        dev = x.device
        outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                     for t in (x, dt, A, B, C, D))
        work = torch.empty((2 * b * H * nc * N * P + 2 * b * L * H * N
                            + 3 * b * H * nc,), dtype=torch.float32,
                           device=dev)
        st = _build.strides_arg(*x.stride()[:3], *dt.stride(),
                                *B.stride()[:3], *C.stride()[:3],
                                *dy.stride()[:3])
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), dy.data_ptr(),
                *[o.data_ptr() for o in outs],
                b, L, H, G, P, N, Q, st, work.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "ssd_scan_bwd (other tree)")
        return outs
    return call


def ssd_bwd_phase_source(csrc) -> str:
    """``csrc``'s ssd_scan_bwd.cu with each warp of the chunk pass summing
    its cycles per phase of ``SSD_BWD_PHASES``, written to ``g_ph[block *
    8 + warp]`` at the end (``probe_phases`` as for the forward)."""
    src = open(os.path.join(csrc, "ssd_scan_bwd.cu")).read()
    prelude = SSD_PRELUDE.replace("[8]", "[16]").replace(
        "{0, 0, 0, 0, 0, 0, 0, 0}", "{}")
    src = src.replace('#include "hopper.cuh"\n',
                      '#include "hopper.cuh"\n' + prelude, 1)
    cut = src.index("// ---- launch 3")
    head, body = src[:cut], src[cut:]
    for k, (name, anchor) in enumerate(SSD_BWD_PHASES):
        if anchor not in body:
            raise RuntimeError(f"phase anchor of {name!r} not found")
        mark = "  PH_INIT\n" if k == 0 else f"    PH({k - 1});\n"
        if name.startswith("<"):
            body = body.replace(anchor, mark + anchor, 1)
        else:
            i = body.index(anchor) + len(anchor)
            body = body[:i] + mark + body[i:]
    end = "  write_rows<N>(a, un, t, nt, acc, a.dB, a.ws_db);\n}\n"
    if end not in body:
        raise RuntimeError("chunk pass end not found")
    done = ("  if ((threadIdx.x & 31) == 0)\n"
            "    for (int k_ = 0; k_ < 16; ++k_)\n"
            "      g_ph[blockIdx.x * 8 + (threadIdx.x >> 5)][k_] = "
            "ph_acc[k_];\n")
    body = body.replace(end, end[:-2] + done + "}\n", 1)
    return head + body + SSD_EPILOGUE.replace("* 8 * 8 * 8", "* 8 * 16 * 8")\
        .replace("zero[16384][8]", "zero[16384][16]")


def probe_ssd_bwd(out, others=()):
    """This tree's SSD backward (and each of ``others``, NAME=DIR) held to
    the plain version and timed in turns at the train step's shapes."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    import chip_smoke as cs
    tmp = tempfile.mkdtemp()
    staged = os.path.join(tmp, "ssd_bwd_phases.cu")
    with open(staged, "w") as f:
        f.write(ssd_bwd_phase_source(str(_build.CSRC)))
    srcs = {"this tree": os.path.join(str(_build.CSRC), "ssd_scan_bwd.cu"),
            "phases": staged}
    for other in others:
        name, d = other.split("=", 1)
        srcs[name] = os.path.join(os.path.abspath(d), "ssd_scan_bwd.cu")
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", src, "-o", os.path.join(tmp, f"ssd_bwd{i}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (k, src) in enumerate(srcs.items())}
    calls, builds = {}, {}
    for i, (k, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {k}:\n{log}")
        builds[k] = cs.ptxas_report(log, ("ssd_bwd_",))
        lib = _load_lib(os.path.join(tmp, f"ssd_bwd{i}.so"))
        calls[k] = _ssd_bwd_caller(lib, srcs[k])
        if k == "phases":
            lib.probe_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
            phase_lib = lib
    out({"probe": "ssd_bwd", "builds": builds})
    phase_names = [n.lstrip("<") for n, _ in SSD_BWD_PHASES[1:]]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    saved = _build._LIB
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    try:
        for what, H, N in (("mamba2-2.7b train, NanoFlow half", 80, 128),
                           ("zamba2-1.2b train, NanoFlow half", 64, 64)):
            args = cs.ssd_inputs(g, 1, 2048, H, 64, N)
            dy = torch.randn((1, 2048, H, 64), generator=g,
                             device=dev).to(torch.bfloat16)
            want = ssd.ssd_scan_bwd_plain(*args, dy)
            checks = {}
            for k, call in calls.items():
                got, again = call(*args, dy), call(*args, dy)
                torch.cuda.synchronize()
                row = cs.compare_bwd("ssd_scan_bwd", [
                    (a, w) for a, w in zip(got, want)
                    if a.dtype == torch.bfloat16])
                row["f32_rel_l2"] = {n: cs.rel_err(a, w) for n, a, w in zip(
                    names, got, want) if a.dtype == torch.float32}
                row["same_bits_twice"] = all(
                    torch.equal(a, c) for a, c in zip(got, again))
                checks[k] = row
            fns = {k: (lambda call=call: call(*args, dy))
                   for k, call in calls.items() if k != "phases"}
            order = [k for k in fns if k != "this tree"]
            turns = order + ["this tree", "this tree"] + order[::-1] \
                if order else ["this tree", "this tree"]
            times: dict = {}
            for k in turns:
                times.setdefault(k, []).append(cs.device_ms([fns[k]])[0])
            passes = {k: cs.pass_ms(fn, SSD_BWD_PASSES)
                      for k, fn in fns.items()}
            # the chunk pass's cycles per phase, a warp's mean over units
            # (warp w holds row tile 7 - w or w - 4)
            phase_lib.probe_phases(None, 0)
            calls["phases"](*args, dy)
            torch.cuda.synchronize()
            Q = ssd.chunk_len(2048, 128)
            units = ssd.ssd_bwd_geometry(1, 2048, H, 1, N, Q,
                                         ssd.sm_count(0))["units"]
            buf = (ctypes.c_longlong * (units * 128))()
            phase_lib.probe_phases(buf, units)
            per_warp = {w: {n: sum(buf[(u * 8 + w) * 16 + k]
                                   for u in range(units)) / units
                            for k, n in enumerate(phase_names)}
                        for w in range(8)}
            out({"probe": "ssd_bwd", "case": f"{what}: b=1 L=2048 H={H} "
                 f"P=64 G=1 N={N}", "checks": checks,
                 "device_ms_turns": times, "pass_device_ms": passes,
                 "chunk_cycles_per_unit": per_warp})
    finally:
        _build._LIB = saved


FUSED_CTAS = (16, 32, 66, 132, 264)
# (bucket, anchor in fused_add_rmsnorm.cu, where the mark goes): each warp
# adds the clock64 cycles since its previous mark to the bucket ("<":
# before the anchor, else after it; "init" starts the clock)
FUSED_MARKS = [
    ("<init", "      for (int i = 0; i < rows; ++i) {\n"),
    ("producer: wait empty",
     "        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);\n"),
    ("producer: issue loads",
     "        bulk_load(buf + row_bytes, y + (row0 + i) * sy, row_bytes, "
     "&full[st]);\n"),
    ("<init", "  for (int i = grp, k = 0; i < rows; i += groups, ++k) {\n"),
    ("consumer: wait full", "    mbar_wait(&full[st], (i / stages) & 1);\n"),
    ("<consumer: smem loads, sum",
     "#pragma unroll\n    for (int off = 16; off > 0; off >>= 1)"),
    ("<consumer: shuffles, barrier", "    const float r = rsqrtf("),
    ("consumer: scale, stores",
     "        gs[j].apply(sv[j], r, h + row * sh + 8 * v);\n      }\n    }\n"),
]
FUSED_BUCKETS = [n for n, _ in FUSED_MARKS if n != "<init"]
# copies of fused_add_rmsnorm.cu without one half of its traffic: no
# stores (s = x + y and its statistics are computed, nothing is written,
# so h is not computed either), no loads (the producer arrives on each
# stage without a copy: the consumers read what the ring holds), neither
_NO_STORES = ("        store(s + row * ss + 8 * v, sv[j]);\n"
              "        gs[j].apply(sv[j], r, h + row * sh + 8 * v);\n",
              "        if (sv[j][0] == 12345.f && r == 12345.f)\n"
              "          gs[j].apply(sv[j], r, h + row * sh + 8 * v);\n")
_NO_LOADS = ("        mbar_arrive_expect_tx(&full[st], 2 * row_bytes);\n"
             "        bulk_load(buf, x + (row0 + i) * sx, row_bytes, "
             "&full[st]);\n"
             "        bulk_load(buf + row_bytes, y + (row0 + i) * sy, "
             "row_bytes, &full[st]);\n",
             "        mbar_arrive(&full[st]);\n")
FUSED_HALVES = {"no stores": [_NO_STORES], "no loads": [_NO_LOADS],
                "neither": [_NO_STORES, _NO_LOADS]}


def fused_half_source(csrc, name) -> str:
    """``csrc``'s fused_add_rmsnorm.cu with the edits of
    ``FUSED_HALVES[name]``."""
    src = open(os.path.join(csrc, "fused_add_rmsnorm.cu")).read()
    for old, new in FUSED_HALVES[name]:
        if old not in src:
            raise RuntimeError(f"{name}: anchor not found")
        src = src.replace(old, new)
    return src
FUSED_PRELUDE = r'''
__device__ long long g_fph[4096][24][8];  // blocks, warps, buckets
#define PH_INIT long long ph_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long ph_t = clock64();
#define PH(k) do { const long long t_ = clock64(); ph_acc[k] += t_ - ph_t; \
  ph_t = t_; } while (0)
#define PH_OUT do { if (blockIdx.x < 4096) for (int k_ = 0; k_ < 8; ++k_) \
  g_fph[blockIdx.x][threadIdx.x >> 5][k_] = ph_acc[k_]; } while (0)
'''
FUSED_EPILOGUE = r'''
extern "C" int probe_fused_cycles(void* host, int n) {
  static long long zero[4096][24][8];
  if (host == nullptr) return (int)cudaMemcpyToSymbol(g_fph, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_fph, (size_t)n * 24 * 8 * 8);
}
'''


def fused_cycles_source(csrc) -> str:
    """``csrc``'s fused_add_rmsnorm.cu with each warp's cycles summed per
    bucket of ``FUSED_MARKS`` and written to ``g_fph[block][warp]`` as the
    producer's lane 0 and each consumer lane 0 finish."""
    src = open(os.path.join(csrc, "fused_add_rmsnorm.cu")).read()
    src = src.replace('#include "norm_pack.cuh"\n',
                      '#include "norm_pack.cuh"\n' + FUSED_PRELUDE, 1)
    k = 0
    for name, anchor in FUSED_MARKS:
        if anchor not in src:
            raise RuntimeError(f"mark anchor of {name!r} not found")
        if name == "<init":
            mark = "  PH_INIT\n"
        else:
            mark, k = f"    PH({k});\n", k + 1
        if name.startswith("<"):
            src = src.replace(anchor, mark + anchor, 1)
        else:
            src = src.replace(anchor, anchor + mark, 1)
    for anchor, out in (
            ("      }\n    }\n    return;\n  }\n", "      }\n      PH_OUT;\n"
             "    }\n    return;\n  }\n"),
            ("  }\n}\n\ntemplate <typename TX, typename TG, int NP>\nint launch(",
             "  }\n  if (lane == 0) PH_OUT;\n}\n\ntemplate <typename TX, "
             "typename TG, int NP>\nint launch(")):
        if anchor not in src:
            raise RuntimeError("kernel end not found")
        src = src.replace(anchor, out, 1)
    return src + FUSED_EPILOGUE


def _other_rmsnorm(name, root):
    """The ``kernels.rmsnorm`` module of the tree at ``root``, its
    ``src/repro_torch`` imported as the package ``_other_<name>``."""
    pkg = f"_other_{name}"
    base = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        pkg, os.path.join(base, "__init__.py"),
        submodule_search_locations=[base])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[pkg] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.kernels.rmsnorm")


def fused_probe_geometry(n, d, block_rows, *, cw=None, wpr=None,
                         max_stages=64):
    """``rmsnorm.fused_geometry`` of bf16 rows with ``cw`` consumer warps
    in rows of ``wpr`` warps and at most ``max_stages`` ring stages in
    their place (a probe point: the wrapper launches only the first);
    the ring takes as many stages as fit, in whole groups where it
    wraps."""
    from repro_torch.kernels import rmsnorm as rn
    geo = rn.fused_geometry(n, d, block_rows)
    wpr = wpr or geo["warps_per_row"]
    cw = cw or geo["consumer_warps"]
    packs = next(p for p in rn.NORM_PACKS if 256 * wpr * p >= d)
    groups, rows = cw // wpr, max(1, min(block_rows, n))
    stages = min(max_stages, (rn.SMEM_PER_BLOCK - 8 * cw) // (4 * d + 16))
    if stages < rows:
        stages = max(stages // groups, 1) * groups
    stages = min(stages, rows)
    return dict(geo, threads=32 * (1 + cw), consumer_warps=cw,
                warps_per_row=wpr, packs=packs, groups=groups, stages=stages,
                smem_bytes=stages * (4 * d + 16) + 8 * cw)


def fused_launch(lib, x, y, w, block_rows, geo):
    """One launch of ``lib``'s fused add+RMSNorm on bf16 (n, d) rows at
    the geometry ``geo``, straight through its C entry point."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    n, d = x.shape
    s, h = torch.empty_like(x), torch.empty_like(x)
    _build.check(lib.repro_fused_add_rmsnorm_fwd(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), s.data_ptr(), h.data_ptr(),
        n, d, d, d, d, d, 0, 0, block_rows, geo["stages"],
        geo["warps_per_row"], geo["packs"], geo["consumer_warps"], rn.EPS,
        torch.cuda.current_stream().cuda_stream), "fused_add_rmsnorm")
    return s, h


def probe_fused(out, others=()):
    """The fused add+RMSNorm kernel over ``FUSED_CTAS`` at the two
    TokenWeave cases, and at TokenWeave's block_rows (256) over consumer
    warps and warps a row (``wpr``; the outputs are the same bits at
    every point of the same wpr) and with the ring cut to 5 and 10
    stages, beside the composition and each of ``others`` (NAME=DIR), in
    turns; then copies without the stores, the loads or both
    (``FUSED_HALVES``) in turns with the whole kernel, and a copy that sums
    each warp's cycles per bucket of ``FUSED_MARKS`` at block_rows 256.
    The wrapper launches the block-count sweep; the other points go
    straight to the library (``fused_launch``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    import chip_smoke as cs
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mods = {k: _other_rmsnorm(k, d) for k, d in
            (o.split("=", 1) for o in others)}
    tmp = tempfile.mkdtemp()
    srcs = {"cycles": fused_cycles_source(str(_build.CSRC)),
            **{k: fused_half_source(str(_build.CSRC), k)
               for k in FUSED_HALVES}}
    procs = {}
    for i, (k, src) in enumerate(srcs.items()):
        with open(os.path.join(tmp, f"fused{i}.cu"), "w") as f:
            f.write(src)
        procs[k] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", os.path.join(tmp, f"fused{i}.cu"), "-o",
             os.path.join(tmp, f"fused{i}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    lib = _build.library()

    def point(br=256, **kw):
        geo = fused_probe_geometry(x.shape[0], x.shape[1], br, **kw)
        return lambda: fused_launch(lib, x, y, w, br, geo)

    cases = (("chatglm3-6b seq_parallel=False B=2", 4096, 4096),
             ("zamba2-1.2b shared block B=4", 8192, 4096))
    for what, n, d in cases:
        x, y = (torch.randn((n, d), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
        ref = rn.fused_add_rmsnorm_plain(x, y, w)
        nbytes = (4 * n * d + d) * 2
        bound_ms = cs.bound(6.0 * n * d, nbytes)["bound_ms"]
        fns, checks, first = {}, {}, {}
        for ctas in FUSED_CTAS:
            br = -(-n // ctas)
            fns[f"kernel br={br}"] = (
                lambda br=br: rn.fused_add_rmsnorm(x, y, w, block_rows=br))
            for name, mod in mods.items():
                fns[f"{name} br={br}"] = (
                    lambda mod=mod, br=br: mod.fused_add_rmsnorm(
                        x, y, w, block_rows=br))
        for wpr, cw in ((4, 4), (4, 8), (4, 12), (4, 16), (8, 16), (2, 8)):
            fns[f"kernel wpr={wpr} cw={cw} br=256"] = point(cw=cw, wpr=wpr)
        for m in (5, 10):
            fns[f"kernel stages<={m} br=256"] = point(max_stages=m)
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            checks[k] = cs.compare("fused_add_rmsnorm",
                                   list(zip(got, ref)))["ok"]
            if k.startswith("kernel"):
                # the same bits wherever a row has the same warps
                wk = k.split("wpr=")[1].split()[0] if "wpr=" in k else ""
                first.setdefault(wk, got)
                checks[k] = checks[k] and bool(
                    torch.equal(got[0], first[wk][0])
                    and torch.equal(got[1], first[wk][1]))
        fns["composition"] = lambda: F.rms_norm(torch.add(x, y), (d,), w,
                                                rn.EPS)
        times: dict = {}
        for k in list(fns) + list(fns)[::-1]:
            times.setdefault(k, []).append(cs.device_ms([fns[k]]))
        rows = {}
        for k, t in times.items():
            ms = sum(t) / 2
            br = int(k.rsplit("=", 1)[1]) if "br=" in k else None
            ctas = None if br is None else -(-n // br)
            busy = None if ctas is None else min(ctas, sms)
            rows[k] = {"device_ms_turns": t, "device_ms": ms,
                       "ctas": ctas, "ok": checks.get(k, True),
                       "share_of_bound": bound_ms / ms,
                       "bytes_per_sm_per_us": (
                           None if busy is None
                           else nbytes / busy / (ms * 1e3))}
        out({"probe": "fused", "case": f"{what}: n={n} d={d} bf16",
             "bound_ms": bound_ms, "sms": sms,
             "geometry": {f"br={-(-n // c)}": rn.fused_geometry(
                 n, d, -(-n // c)) for c in FUSED_CTAS},
             "results": rows})
    libs, logs = {}, {}
    for i, (k, p) in enumerate(procs.items()):
        logs[k] = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {k} build:\n{logs[k]}")
        libs[k] = _load_lib(os.path.join(tmp, f"fused{i}.so"))
    # each half of the kernel alone, in turns with the whole
    for what, n, d in cases:
        x, y = (torch.randn((n, d), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
        geo = rn.fused_geometry(n, d, 256)
        fns = {"whole": lambda: fused_launch(lib, x, y, w, 256, geo)}
        for k in FUSED_HALVES:
            fns[k] = (lambda half=libs[k]: fused_launch(half, x, y, w, 256,
                                                        geo))
        times = {}
        for k in list(fns) + list(fns)[::-1]:
            try:
                t = cs.device_ms([fns[k]])
            except RuntimeError as e:     # the profiler's window
                t = str(e)
            times.setdefault(k, []).append(t)
        nbytes = (4 * n * d + d) * 2
        out({"probe": "fused halves", "case": f"{what}: n={n} d={d} "
             f"bf16 block_rows=256", "device_ms_turns": times,
             "bytes_per_sm_per_us_whole": nbytes / min(
                 -(-n // 256), sms) / (max(times["whole"]) * 1e3)})
    cyc_lib = libs["cycles"]
    cyc_lib.probe_fused_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for what, n, d in cases:
        x, y = (torch.randn((n, d), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        w = torch.randn((d,), generator=g, device=dev).to(torch.bfloat16)
        for cw in (8, None):
            geo = fused_probe_geometry(n, d, 256, cw=cw)
            fused_launch(cyc_lib, x, y, w, 256, geo)
            torch.cuda.synchronize()
            cyc_lib.probe_fused_cycles(None, 0)
            fused_launch(cyc_lib, x, y, w, 256, geo)
            torch.cuda.synchronize()
            nb, nw = geo["ctas"], 1 + geo["consumer_warps"]
            buf = (ctypes.c_longlong * (nb * 24 * 8))()
            cyc_lib.probe_fused_cycles(buf, nb)
            # cycles a row: the producer's over a block's 256 rows, a
            # consumer warp's over its group's share
            cyc = {}
            for k, name in enumerate(FUSED_BUCKETS):
                prod = name.startswith("producer")
                ws = [0] if prod else range(1, nw)
                tot = sum(buf[(b * 24 + wi) * 8 + k]
                          for b in range(nb) for wi in ws)
                cyc[name] = tot / nb / len(ws) / (
                    256 if prod else 256 / geo["groups"])
            out({"probe": "fused cycles", "case": f"{what}: n={n} d={d} "
                 f"bf16 block_rows=256 cw={geo['consumer_warps']}",
                 "geometry": geo, "cycles_per_row": cyc})
    out({"probe": "fused cycles", "build": cs.ptxas_report(
        logs["cycles"], ("fused_kernelI13__nv_bfloat16S",))})


# copies of csrc/rmsnorm_bwd.cu whose row loads (ld_row) and row stores
# (st_row), or both, carry the cache-streaming hint (evict first: each row
# byte is read once and written once)
CS_LOAD = ("return *reinterpret_cast<const uint4*>(p);",
           "return __ldcs(reinterpret_cast<const uint4*>(p));")
CS_STORE = ("*reinterpret_cast<uint4*>(p) = v;",
            "__stcs(reinterpret_cast<uint4*>(p), v);")
NORM_BWD_VARIANTS = {"streaming loads and stores": (CS_LOAD, CS_STORE),
                     "streaming loads": (CS_LOAD,),
                     "streaming stores": (CS_STORE,)}


def norm_bwd_launch(lib, fused, x, gw, dh, dso, dx, dg, geo, blocks):
    """One call of ``lib``'s norm backward (both launches) on bf16 (n, d)
    rows at ``geo``'s row geometry and ``blocks`` blocks."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    n, d = x.shape
    work = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    args = (geo["warps_per_row"], geo["packs"], blocks,
            torch.cuda.current_stream().cuda_stream)
    if fused:
        rc = lib.repro_fused_add_rmsnorm_bwd(
            x.data_ptr(), gw.data_ptr(), dh.data_ptr(), dso.data_ptr(),
            dx.data_ptr(), dg.data_ptr(), work.data_ptr(), n, d, d, d, d, d,
            rn.EPS, *args)
    else:
        rc = lib.repro_rmsnorm_bwd(
            x.data_ptr(), gw.data_ptr(), dh.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), work.data_ptr(), n, d, d, d, d, rn.EPS, *args)
    _build.check(rc, "norm_bwd probe")
    return dx, dg


def probe_norm_bwd(out):
    """Both norm backwards over grids of 1-6 blocks an SM at the train
    shapes, and at the geometry's grid the copies of
    ``NORM_BWD_VARIANTS``, launched straight through the libraries' entry
    points, all in turns."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    import chip_smoke as cs
    lib = _build.library()
    tmp = tempfile.mkdtemp()
    procs = {}
    for i, (k, edits) in enumerate(NORM_BWD_VARIANTS.items()):
        src = (_build.CSRC / "rmsnorm_bwd.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant anchor {old!r} not found")
            src = src.replace(old, new)
        with open(os.path.join(tmp, f"norm_bwd{i}.cu"), "w") as f:
            f.write(src)
        procs[k] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             os.path.join(tmp, f"norm_bwd{i}.cu"), "-o",
             os.path.join(tmp, f"norm_bwd{i}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    variants = {}
    for i, (k, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {k} copy:\n{log}")
        variants[k] = _load_lib(os.path.join(tmp, f"norm_bwd{i}.so"))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    for fused in (False, True):
        for n, d in ((16384, 576), (4096, 4096)):
            x, gw, dh, dso = randn(n, d), randn(d), randn(n, d), randn(n, d)
            want = (rn.fused_add_rmsnorm_bwd_plain(x, gw, dh, dso) if fused
                    else rn.rmsnorm_bwd_plain(x, gw, dh))
            geo = rn.norm_bwd_geometry(n, d, sms)
            dx, dg = torch.empty_like(x), torch.empty_like(gw)
            points = {}
            for per_sm in range(1, 7):
                blocks = min(sms * per_sm, -(-n // geo["rows_at_once"]))
                points[f"{per_sm} an SM"] = (lib, blocks)
            for k, other in variants.items():
                points[f"{k}, the geometry's grid"] = (other, geo["blocks"])
            res = {}
            for k, (which, blocks) in points.items():
                got = norm_bwd_launch(which, fused, x, gw, dh, dso, dx, dg,
                                      geo, blocks)
                torch.cuda.synchronize()
                res[k] = dict(blocks=blocks,
                              rel_l2=[cs.rel_err(got[0], want[0]),
                                      cs.rel_err(got[1], want[-1])],
                              device_ms_turns=[])
            for k in list(points) + list(points)[::-1]:
                which, blocks = points[k]
                res[k]["device_ms_turns"].append(cs.device_ms([
                    lambda w=which, b=blocks: norm_bwd_launch(
                        w, fused, x, gw, dh, dso, dx, dg, geo, b)])[0])
            wrapper = ((lambda: rn.fused_add_rmsnorm_bwd(x, gw, dh, dso))
                       if fused else (lambda: rn.rmsnorm_bwd(x, gw, dh)))
            out({"probe": "norm_bwd",
                 "kernel": "fused_add_rmsnorm_bwd" if fused
                 else "rmsnorm_bwd",
                 "case": f"n={n} d={d} bf16", "geometry": geo,
                 "info": rn.norm_bwd_info(geo["warps_per_row"], geo["packs"],
                                          fused),
                 "pass_device_ms": cs.pass_ms(
                     wrapper, ("norm_bwd_kernel", "norm_bwd_dg_kernel")),
                 "points": res})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probes",
                    default="decode,rmsnorm,ssd,fused,norm_bwd,ssd_bwd")
    ap.add_argument("--ssd-other", action="append", default=[],
                    help="NAME=DIR: the ssd_scan.cu of another tree's "
                         "kernels/csrc directory, timed beside this one's")
    ap.add_argument("--fused-other", action="append", default=[],
                    help="NAME=DIR: the fused add+RMSNorm of the tree whose "
                         "root is DIR, timed beside this one's")
    ap.add_argument("--ssd-bwd-other", action="append", default=[],
                    help="NAME=DIR: the ssd_scan_bwd.cu of another tree's "
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
    if "fused" in probes:
        probe_fused(out, args.fused_other)
    if "norm_bwd" in probes:
        probe_norm_bwd(out)
    if "ssd_bwd" in probes:
        probe_ssd_bwd(out, args.ssd_bwd_other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
