"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a name keyed by a hash of every
file in ``csrc/`` and of the flags, so an edited source is rebuilt and an
unchanged one is not.  ``build()`` starts one ``nvcc`` per source, all at
once, and waits for them together.

Only sources in this package's ``csrc/`` are built.  Every C entry point
returns its ``cudaGetLastError()``; ``check()`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("kruskal_contract", "kruskal_grad", "scatter_accum",
           "segment_reduce", "tucker_matmul", "flash_attention",
           "flash_attention_bwd", "mode_product_rows")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc``: on ``PATH``, else under /usr/local/cuda."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def source_digest() -> str:
    """Hash of every file in ``csrc/`` and of the compile flags."""
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest()}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: tuple[str, ...] = SOURCES) -> dict[str, float]:
    """Build every library in ``names`` that is not built yet, in parallel.

    Returns the seconds each build took (0.0 when it was already built).
    ``nvcc``'s report (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside each library as ``<name>-<digest>.log``.  Raises with
    the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    secs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        report, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failures:
        raise RuntimeError("\n".join(failures))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of library ``name`` with its ``argtypes`` set."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise when a C entry returned a CUDA error code other than 0."""
    if code != 0:
        msg = load(name).repro_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {code} ({msg})")
