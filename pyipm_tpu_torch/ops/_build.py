"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` into a shared library with a plain C
interface, at first use, into ``pyipm_tpu_torch/_build/`` (listed in
``.gitignore``).  The library name carries a hash of the source and the
flags, so an edited source is rebuilt.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "small_ldlt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"small_ldlt_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless a library for this source exists (or
    always, with ``force``)."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with every entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"pyipm_ldlt_factor_{dt}")
        fn.argtypes = [P, P, P, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"pyipm_ldlt_solve_{dt}")
        fn.argtypes = [P, P, P, P, I, I, P]
        fn.restype = I
    lib.pyipm_error_string.argtypes = [I]
    lib.pyipm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.pyipm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
