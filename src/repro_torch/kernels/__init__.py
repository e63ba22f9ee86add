"""Hand-written Hopper kernels for the compute hot-spots, each beside its
plain PyTorch version (the port of the JAX package's ``kernels/ref.py``):

  flash_attention.py   blockwise online-softmax attention   (CUDA C++)
  decode_attention.py  flash-decode against a KV cache      (CUDA C++)
  rmsnorm.py           RMSNorm and fused residual-add +
                       RMSNorm                              (Triton)
  tokenweave.py        reduce-scatter + fused add/norm + all-gather
  ops.py               the dispatch the model code calls

A wrapper given a CUDA tensor launches its kernel or raises; a tensor on
the CPU or the ``meta`` device takes the plain version.  Every launch
adds one to ``LAUNCHES[name]``, so a run can show which kernels its main
path went through.
"""
import collections

LAUNCHES = collections.Counter()


def reset_launch_counts():
    LAUNCHES.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)
