"""Hand-written CUDA kernels for the hot loops, behind a backend registry.

Layout (counterparts of ``repro.kernels``):

    dispatch.py          named-backend registry ("torch" | "cuda";
                         $REPRO_TORCH_KERNEL_BACKEND overrides the default
                         "cuda") + the ``KruskalPredict`` autograd Function
    kruskal_contract.py  Theorem-1 forward contraction
    kruskal_grad.py      fused forward + Eq. 13/17 gradient pass
    scatter_accum.py     factor-row scatter of unsorted row gradients
    ref.py               plain PyTorch versions of every kernel (oracles)
    build.py             nvcc build (sm_90a) + ctypes loading of csrc/*.cu
    csrc/                the CUDA C++ sources

Each kernel wrapper counts its launches in a plain integer attribute
(``kruskal_grad.kruskal_grad.launches``, …), raised only where it launches
its CUDA kernel; ``launch_counts`` reads them all and
``reset_launch_counts`` sets them to 0.
"""
from . import dispatch, kruskal_contract, kruskal_grad, ref, scatter_accum
from .dispatch import get_backend

KERNELS = (kruskal_contract.kruskal_contract, kruskal_grad.kruskal_grad,
           scatter_accum.scatter_accum)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "dispatch",
    "ref",
    "get_backend",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]
