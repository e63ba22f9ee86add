"""Hand-written Hopper kernels for the compute hot-spots, each beside its
plain PyTorch version (the port of the JAX package's ``kernels/ref.py``):

  flash_attention.py   blockwise online-softmax attention   (CUDA C++)
  decode_attention.py  flash-decode against a KV cache      (CUDA C++)
  rmsnorm.py           RMSNorm                              (CUDA C++)
                       and fused residual-add + RMSNorm     (CUDA C++)
  grouped_matmul.py    grouped SwiGLU expert FFN            (CUDA C++)
                       and its gate's backward              (CUDA C++)
  ssd_scan.py          Mamba2 chunked SSD scan              (CUDA C++)
                       and its backward                     (CUDA C++)
  adamw.py             multi-tensor AdamW update            (CUDA C++)
  tokenweave.py        reduce-scatter + fused add/norm + all-gather
  ops.py               the dispatch the model code calls
  cost.py              each kernel's operations and bytes, from its shapes

A wrapper given a CUDA tensor launches its kernel or raises; a tensor on
the CPU takes the plain version.  A tensor on the ``meta`` device takes
the meta route (``meta_route``): results of the plain version's shapes
and dtypes, nothing computed, and the kernel's ``cost.py`` count charged
to the dry run's counter (``roofline/count.py``) while one counts.  Every
CUDA wrapper passes its tensor operands through ``kernel_ready``.  Every
launch adds one to ``LAUNCHES[name]``, so a run can show which kernels
its main path went through; a CUDA Graph's replay adds the launches its
capture recorded (``core/capture.py``).  A meta route launches nothing
and counts nothing there.
"""
import collections
import functools

import torch

LAUNCHES = collections.Counter()


def meta_route(name: str, cost, make):
    """Kernel ``name`` on ``meta`` tensors: ``make()``'s results (empty
    tensors of the plain version's shapes and dtypes), with ``cost`` (a
    ``cost.Cost``) charged to the dry run's counter while one counts
    (``roofline/count.py``'s ``Counter.current``), in place of its count
    of the ops ``make`` dispatches."""
    from ..roofline.count import Counter
    if Counter.current is None:
        return make()
    with Counter.current.kernel(name, cost):
        return make()


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


def _not_capturing(what: str, stream: int):
    """Raise where a wrapper would make its cached per-stream state (a
    workspace zeroed once) while a CUDA Graph captures: the allocation
    would come from the graph's pool and its zeroing would replay with
    the graph.  The step's warm-up must run the plan on the same streams
    first (``core/capture.py``, ``core/streams.py:side_stream``)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"kernel {what} for stream {stream:#x} first made under CUDA "
            "Graph capture: warm the step up on the same streams first")


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
