"""DynaFlow on PyTorch and CUDA — the port of ``src/repro`` to one NVIDIA
H100.

The model stays a plain sequential program; a programmable scheduler
records the physical schedule (micro-batch splits, merges, fused
replacement kernels, op order around collectives) and the backend
realizes it.  ``repro_torch.api.compile`` is the entry point.  This
package imports neither JAX nor the JAX package.
"""
