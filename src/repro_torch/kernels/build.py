"""Build the hand-written kernels with ``nvcc`` and load them with ``ctypes``.

One module for every kernel family: ``kernels/attn/csrc`` (K3-K6),
``kernels/dfxp/csrc`` (K1) and ``kernels/qmatmul/csrc`` (K2).  Each
``csrc/<name>.cu`` has a plain ``extern "C"`` entry point and no PyTorch
headers, so one ``nvcc`` call per source builds in seconds.  The
libraries go to ``build/repro_torch/`` under the repository root, named
by a hash of their own source and the headers of their directory, so an
edited source rebuilds and an unchanged one is reused.  Building happens
at first use (:func:`library`), or for all kernels at once, in parallel,
through :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# family directory, entry point and argument types of each kernel library
SIGNATURES = {
    "flash_decode": ("attn", "flash_decode_launch",
                     [_P] * 8 + [_I] * 6 + [_F] + [_I] * 4 + [_P]),
    "flash_prefill": ("attn", "flash_prefill_launch",
                      [_P] * 11 + [_I] * 7 + [_F] + [_I] * 4 + [_P]),
    "flash_decode_paged": ("attn", "flash_decode_paged_launch",
                           [_P] * 9 + [_I] * 7 + [_F] + [_I] * 4 + [_P]),
    "flash_prefill_paged": ("attn", "flash_prefill_paged_launch",
                            [_P] * 12 + [_I] * 8 + [_F] + [_I] * 4 + [_P]),
    "dfxp_quantize": ("dfxp", "dfxp_quantize_launch",
                      [_P] * 3 + [_F, _P, _P, _L, _I, _I, _P]),
    "qmatmul": ("qmatmul", "qmatmul_launch",
                [_P] * 5 + [_I] * 9 + [_P]),
}


def csrc(name: str) -> Path:
    """The ``csrc`` directory that holds kernel ``name``'s source."""
    return KERNELS / SIGNATURES[name][0] / "csrc"

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current sources."""
    h = hashlib.sha256()
    for src in sorted(csrc(name).iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.stem == name
                                              or src.suffix == ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(csrc(name) / f"{name}.cu")]


def build_all(names=None, force: bool = False) -> Dict[str, dict]:
    """Build every kernel library at once, one ``nvcc`` per source in
    parallel.  Returns ``{name: {"path", "seconds", "ptxas"}}`` where
    ``ptxas`` is the compiler's register/shared-memory report ("" when the
    library was already built).  Raises on the first failed build."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            report[name] = {"path": str(out), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.parent / f"tmp{os.getpid()}-{out.name}"
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _, fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
