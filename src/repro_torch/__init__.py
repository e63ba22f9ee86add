"""DynaFlow on PyTorch and CUDA — the port of ``src/repro`` to one NVIDIA
H100.

The model stays a plain sequential program; a programmable scheduler
records the physical schedule (micro-batch splits, merges, fused
replacement kernels, op order around collectives) and the backend
realizes it.  ``repro_torch.api.compile`` is the entry point.  This
package imports neither JAX nor the JAX package.

Importing it makes cuBLAS sum a bf16 or fp16 product in f32 to the end,
as the JAX package's products do.  PyTorch's default lets cuBLAS reduce
a split-K product's partial sums in the operands' 16-bit type, and the
backward's weight products (K = every token of the batch) then round
each partial: on an H100 that tripled the gradients' spread between two
schedules of whisper-tiny's train step (5.3% against 2.0% relative L2).
The switch is process-wide because PyTorch has no per-call one, and a
backward's products run outside any op's call.
"""
import torch

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
