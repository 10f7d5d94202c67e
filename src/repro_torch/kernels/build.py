"""Build and load the CUDA kernel library (``csrc/*.cu``) at first use.

Each ``.cu`` under ``csrc/`` (with the ``.cuh`` headers it includes) is
compiled by its own ``nvcc`` process, all started together, for
``sm_90a``; the objects are linked into one shared library with a plain C
interface and loaded with ``ctypes``. The library is named by a hash of
the sources, headers and flags and cached under the checkout's
``build/kernels/`` (listed in ``.gitignore``), so a changed source is
rebuilt and an unchanged one is reused. Nothing here runs at import time:
this module is imported on machines without ``nvcc`` or a GPU.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code. There is no fallback to the plain
PyTorch versions: a CUDA tensor goes to the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
SIGNATURES = {
    "margin_obj": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                   _P, _P, _P, _P, _P, _I, _P],
    "hinge_grad": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                   _I, _P],
    "screen_bounds_features": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                               _P, _P, _I, _I, _P],
    "screen_bounds_samples": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P, _P, _P, _I, _P],
    # the partial modes and their finalizers (a sharded run)
    "margin_partial": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P, _I, _P],
    "margin_finalize": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P],
    "sample_partial": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                       _P],
    "sample_finalize": [_P, _I, _P, _P, _P, _P, _P, _I, _P],
    "screen_partial_features": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                _I, _P],
    "screen_finalize_features": [_P, _P, _I, _I, _P, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the library for the current sources, headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """``nvcc`` output of the last build in this checkout (``-Xptxas -v``
    register and spill counts), or ``""`` when the library was reused."""
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {err} ({msg})")


def on_card(X: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if X.device.type == "cuda":
        return True
    if X.device.type == "cpu":
        return False
    raise ValueError(f"tensors must be on 'cuda' or 'cpu', got {X.device}")


def stream_and_device(X: torch.Tensor) -> tuple[int, int]:
    """``(device index, current stream handle)`` for a launch on X's device."""
    idx = X.device.index if X.device.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(idx).cuda_stream


def check_matrix(X: torch.Tensor, name: str = "X") -> None:
    if X.dim() != 2:
        raise ValueError(f"{name} must be 2-D (m, n), got shape {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")
    if X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"{name} must be non-empty, got shape {tuple(X.shape)}")
    if X.shape[0] >= 2 ** 28 or X.shape[1] >= 2 ** 31:
        raise ValueError(f"{name} shape {tuple(X.shape)} exceeds the kernels' "
                         "32-bit thread and column indexing")


def check_vector(v: torch.Tensor, size: int, like: torch.Tensor, name: str) -> None:
    if v.device != like.device:
        raise ValueError(f"{name} is on {v.device}, X on {like.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {v.dtype}")
    if tuple(v.shape) != (size,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({size},) vector, got "
                         f"shape {tuple(v.shape)}")
