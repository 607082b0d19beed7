"""Build the CUDA kernels under ``ops/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so one source builds in seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and concurrent processes never load a half-written file
(each writes a private temporary and renames it into place).  A kernel builds
at its first use; :func:`build_all` builds every source at once, one ``nvcc``
process per source, all started together.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
KERNELS = ("tiled_matmul", "dma_stream", "flash_attention")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry of each library: (symbol, argtypes).  Every pointer and the stream
# are c_void_p, or ctypes would pass them as 32-bit ints and cut them.
SIGNATURES = {
    "tiled_matmul": ("tnc_tiled_matmul", [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "dma_stream": ("tnc_dma_stream", [_P, _P, _LL, _LL, _LL, _I, _P]),
    "flash_attention": ("tnc_flash_forward", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its stderr."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError(
        f"nvcc not found on PATH or under {cuda_home}/bin: the CUDA kernels "
        "build from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of the
    source, every ``csrc/*.cuh`` header (any source may include one) and the
    flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple:
    """Start nvcc for one source; returns (process or None if built, tmp, lib)."""
    lib = library_path(name)
    if lib.exists():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, lib


def _finish(name: str, proc, tmp: Path, lib: Path) -> Path:
    if proc is None:
        return lib
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{err.strip()}"
        )
    os.replace(tmp, lib)
    return lib


def build_all(names: Iterable[str] = KERNELS) -> List[Path]:
    """Build every named source, all nvcc processes running at once."""
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, proc, tmp, lib) for n, proc, tmp, lib in started]


def kernel(name: str):
    """The C entry of kernel ``name``, building its library on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            (lib_path,) = build_all([name])
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        import torch

        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: {torch.cuda.CudaError(code)}"
        )
