"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into an object, all sources at
once in parallel, and the objects are linked into ONE shared library with a
plain C interface, at first use, into ``pyipm_tpu_torch/_build/`` (listed
in ``.gitignore``).  The library name carries a hash of every source, every
header (``csrc/*.cuh``) and the flags, so an edited file is rebuilt.
Nothing here runs at import.

Also what every wrapper shares: operand checks and the launch itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
DTYPES = {torch.float32: "f32", torch.float64: "f64"}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"pyipm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list[str]:
    """Run the commands at once; raise on the first failure.  Returns each
    command's compiler output (stdout + stderr)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return outs


def build(force: bool = False, verbose: bool = False):
    """Compile the kernels unless a library for these sources exists (or
    always, with ``force``).  Returns (library path, compiler output);
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    out = library_path()
    if out.exists() and not force:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj,
                          str(src)] for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        logs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out, "".join(logs)


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with every entry point's
    argument and return types declared."""
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "pyipm_ldlt_factor": [P, P, P, I, I, P],
        "pyipm_ldlt_solve": [P, P, P, P, P, I, I, P],
        "pyipm_ldlt_solve_residency": [I, P],
        "pyipm_panel_ldlt": [P, P, P, I, I, I, P],
        "pyipm_panel_ldlt_residency": [I, P],
        "pyipm_bwd_sweep_blocks": [P, P, P, P, P, P, I, I, P],
        "pyipm_bwd_sweep_panels": [P, P, P, P, P, I, P],
    }
    for name, args in signatures.items():
        for dt in DTYPES.values():
            fn = getattr(lib, f"{name}_{dt}")
            fn.argtypes = args
            fn.restype = I
    lib.pyipm_error_string.argtypes = [I]
    lib.pyipm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(entry: str, what: str, dtype, device, *args) -> None:
    """Call the library's ``{entry}_f32`` or ``_f64`` (by ``dtype``) with
    ``args`` and the current stream of ``device``; raise on a CUDA error
    (a refused launch never runs, so it must be caught here)."""
    lib = load()
    fn = getattr(lib, f"{entry}_{DTYPES[dtype]}")
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.pyipm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def query(entry: str, what: str, dtype, device, *args, count: int = 1):
    """Call the library's ``{entry}_f32`` or ``_f64`` with ``args`` and an
    int array of ``count`` entries, on ``device``; raise on a CUDA error.
    Returns the array's values (a kernel's launch configuration)."""
    lib = load()
    out = (ctypes.c_int * count)()
    with torch.cuda.device(device):
        code = getattr(lib, f"{entry}_{DTYPES[dtype]}")(*args, out)
    if code != 0:
        msg = lib.pyipm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
    return tuple(out)


def check_operand(name, t, shape, dtype, device):
    """Raise unless ``t`` is a contiguous float32/float64 tensor of the
    given shape, dtype and device."""
    if t.dtype != dtype or t.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                        f"float64 matching the other operands")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
