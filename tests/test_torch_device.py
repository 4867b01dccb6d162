"""Device, build and no-fallback rules of the port, checked on the CPU.

* Without CUDA and without ``device=``, the entry points raise; they never
  carry on on the CPU unasked.
* ``build.py`` forms the ``nvcc`` command for ``sm_90a`` into the
  gitignored ``build/kernels/`` (the command is not run here).
* The CUDA wrappers raise on the phase flags the kernel does not take, and
  on any tensor that is neither on the CPU nor on a CUDA card (``meta``
  tensors stand in for the card here): no silent plain-path fallback.
* ``FastTuckerConfig`` raises on the options still to be ported.
"""
from pathlib import Path

import pytest
import torch

from repro_torch.core import fasttucker as ft
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.kernels import (build, kruskal_contract, kruskal_grad,
                                 scatter_accum)
from repro_torch.launch import std_train

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_or_device(no_cuda):
    cfg = ft.FastTuckerConfig(dims=(5, 4, 3), ranks=(2, 2, 2), core_rank=2)
    calls = [
        lambda: resolve_device(),
        lambda: synthetic.planted_tensor((5, 4, 3), 20),
        lambda: ft.init_params(torch.Generator(), cfg),
        lambda: std_train.run(std_train.parse_args(
            ["--dims", "5,4,3", "--nnz", "20", "--steps", "1"])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_nvcc_command_targets_sm90a_into_gitignored_build_dir():
    out = build.library_path("kruskal_grad")
    cmd = build.nvcc_command("kruskal_grad", out)
    assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-O3", "-shared", "-Xcompiler", "-fPIC", "-std=c++17"):
        assert flag in cmd
    assert cmd[-1] == str(ROOT / "src/repro_torch/kernels/csrc/"
                          "kruskal_grad.cu")
    assert out.parent == ROOT / "build" / "kernels"
    assert out.name.startswith("kruskal_grad-") and out.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    # the key changes with the sources and flags, not from call to call
    assert build.source_digest() == build.source_digest()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("flags", [
    {"c": "cached"}, {"emit_c": True}, {"row_modes": (1,)},
    {"row_modes": ()}, {"want_core": False}])
def test_grad_kernel_raises_on_phase_flags(flags):
    a, b = _meta(3, 8, 4), _meta(3, 4, 4)
    v, s = _meta(8), _meta(5)
    if "c" in flags:
        flags = {"c": _meta(3, 8, 4)}
    with pytest.raises(NotImplementedError):
        kruskal_grad.kruskal_grad(a, b, v, v, s, **flags)


def test_wrappers_refuse_non_cuda_devices_instead_of_falling_back():
    a, b = _meta(3, 8, 4), _meta(3, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kruskal_contract.kruskal_contract(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        kruskal_grad.kruskal_grad(a, b, _meta(8), _meta(8), _meta(5))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_accum.scatter_accum(_meta(8, 4),
                                    _meta(8, dtype=torch.int32), 10)


@pytest.mark.parametrize("option", [
    {"update_order": "gauss_seidel"}, {"phase_split": True},
    {"sorted_batches": True}, {"dtype": "bfloat16"}, {"init": "sketched"}])
def test_config_raises_on_options_not_ported(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        ft.FastTuckerConfig(dims=(5, 4, 3), ranks=(2, 2, 2), core_rank=2,
                            **option)


def test_config_resolves_backend(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    cfg = ft.FastTuckerConfig(dims=(5, 4, 3), ranks=(2, 2, 2), core_rank=2)
    assert cfg.backend == "cuda"
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "torch")
    assert ft.FastTuckerConfig(dims=(5,), ranks=(2,), core_rank=2).backend \
        == "torch"
    with pytest.raises(KeyError):
        ft.FastTuckerConfig(dims=(5,), ranks=(2,), core_rank=2,
                            backend="xla")
