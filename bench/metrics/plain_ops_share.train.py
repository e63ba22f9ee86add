"""plain_ops_share.train: the share of the traced steps' device time in
operations that are neither the port's CUDA kernels nor cuBLAS's GEMMs:
the plain PyTorch ops between the kernels (elementwise, reductions,
copies).  The names below are the kernels of the port's CUDA sources
and cuBLAS's GEMM families, as the profiler reports them."""
import re

PORT = re.compile(r"(^|::)(adamw_kernel|decode_kernel|ffn_gemm_kernel|"
                  r"flash_bwd_\w+_kernel|flash_fwd_kernel|fused_kernel|"
                  r"gate_bwd_kernel|norm_bwd_dg_kernel|norm_bwd_kernel|"
                  r"rmsnorm_kernel|ssd_bwd_\w+|ssd_scan_kernel)[<(]")
GEMM = re.compile(r"nvjet|gemm|gemv|cutlass|xmma|splitK", re.I)


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    total = sum(d for _, _, d in tr["ops"])
    plain = sum(d for name, _, d in tr["ops"]
                if not PORT.search(name) and not GEMM.search(name))
    return 100.0 * plain / total if total else None
