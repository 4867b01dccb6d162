"""PyTorch/CUDA port of the FastTucker sparse Tucker decomposition system.

A second package beside the JAX reference ``repro``: the same module names
(``core.fasttucker`` against ``repro.core.fasttucker``, and so on), written
in PyTorch's idiom, with the reference's Pallas TPU kernels replaced by
CUDA C++ kernels written for Hopper (``kernels/csrc``).  It imports
``torch`` and numpy only — never ``jax`` and never ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA and without ``device=`` they raise
(``repro_torch.device.resolve_device``).

float32 means float32: TF32 is switched off for matmuls and cuDNN here,
so the ``"torch"`` oracle backend computes in full f32 on the card; and
cuBLAS may not reduce a bf16 GEMM in reduced precision (PyTorch's default
lets it), so under ``mixed_precision`` every dot still accumulates in f32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
