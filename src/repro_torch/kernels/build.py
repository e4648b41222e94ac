"""Build a CUDA source of ``kernels/csrc`` into a shared library, at first use.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``, a plain C interface, loaded with :mod:`ctypes` (seconds
to build; PyTorch's own extension builder takes minutes for a file that
includes its headers).  The library lands in ``build/repro_torch/`` at the
repository root (git-ignored), named by a hash of the source, of every
``csrc`` header it includes (transitively, ``#include "..."``) and of the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Every CUDA source of csrc/, one library each (chip_smoke.py builds them all,
# one nvcc each, started together).
SOURCES = ("lut_dequant_gemm", "lut_dequant_gemm_sm90", "lut_stream_gemm",
           "lut_stream_gemm_sm90", "lut_stream_lookup_sm90", "lut_canon", "flash_attention",
           "flash_attention_sm90")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the cached library was reused),
#          "log": nvcc's output (register / shared-memory use per kernel)}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use"
        )
    return found


def local_headers(src: pathlib.Path) -> list[pathlib.Path]:
    """The ``csrc`` headers ``src`` includes with quotes, transitively, in the
    order first met."""
    seen: list[pathlib.Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / inc
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def digest(name: str) -> str:
    """Build key of ``csrc/<name>.cu``: its bytes, its ``csrc`` headers' names
    and bytes, and the nvcc flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in local_headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    lib_path = BUILD_DIR / f"lib{name}_{digest(name)[:16]}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, lib_path)   # atomic: concurrent builders never see half a file
    _loaded[name] = ctypes.CDLL(str(lib_path))
    build_info[name] = {"seconds": seconds, "log": log, "path": str(lib_path)}
    return _loaded[name]
