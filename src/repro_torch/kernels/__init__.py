"""Hand-written Hopper kernels for the compute hot-spots, each beside its
plain PyTorch version (the port of the JAX package's ``kernels/ref.py``):

  flash_attention.py   blockwise online-softmax attention   (CUDA C++)
  decode_attention.py  flash-decode against a KV cache      (CUDA C++)
  rmsnorm.py           RMSNorm                              (CUDA C++)
                       and fused residual-add + RMSNorm     (CUDA C++)
  grouped_matmul.py    grouped SwiGLU expert FFN            (CUDA C++)
  ssd_scan.py          Mamba2 chunked SSD scan              (CUDA C++)
  tokenweave.py        reduce-scatter + fused add/norm + all-gather
  ops.py               the dispatch the model code calls

A wrapper given a CUDA tensor launches its kernel or raises; a tensor on
the CPU or the ``meta`` device takes the plain version.  Every CUDA
wrapper passes its tensor operands through ``kernel_ready``.  Every launch
adds one to ``LAUNCHES[name]``, so a run can show which kernels its main
path went through; a CUDA Graph's replay adds the launches its capture
recorded (``core/capture.py``).
"""
import collections
import functools

import torch

LAUNCHES = collections.Counter()


def kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the CUDA kernels' 16-byte loads, bulk copies and TMA maps
    take it: a unit last stride, a 16-byte aligned base, and every other
    stride a positive multiple of 16 bytes (any stride at extent 1).
    Anything else is copied into fresh storage: ``.contiguous()`` would
    hand back a contiguous tensor at a misaligned base unchanged."""
    esize = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(n == 1 or (s > 0 and s * esize % 16 == 0)
                  for s, n in zip(t.stride()[:-1], t.shape[:-1])))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels'
    geometries (the persistent grids, the flash backward's split) follow
    it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launch_counts():
    LAUNCHES.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)
