"""Build the CUDA sources of ``csrc/`` into one shared library and load it.

``nvcc`` compiles each source for ``sm_90a`` (all started together), links
the objects into ``_build/libreprotorch_<hash>.so`` and the library is loaded
with ctypes.  The hash covers the sources, headers and flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  The build runs at
the first launch of a kernel; it needs the CUDA toolkit, never the network.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["build", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu",
            "decode_attention.cu", "moe_gating.cu", "moe_router_bwd.cu", "ssd_scan.cu",
            "ssd_scan_bwd.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile (unless an up-to-date library exists) and return the library
    path and the compiler's output (``ptxas`` register and spill counts)."""
    so = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if so.exists():
        return so, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(src).stem + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", str(_CSRC / src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_SOURCES, objs)]
        log = []
        for src, proc in zip(_SOURCES, procs):
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run([nvcc, "-shared", *_FLAGS[:2], *objs, "-o", tmp_so],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    return so, "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 9 + [
            i64p, ctypes.c_float, ptr]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [
            i64p, ctypes.c_float, ptr]
        lib.flash_attention_bwd.restype = i32
        lib.flash_decode_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, ptr] + [i32] * 8 + [
            i64p, ctypes.c_float, ptr, ptr, ptr]
        lib.flash_decode_fwd.restype = i32
        lib.moe_gating_fwd.argtypes = [ptr, ptr, ptr] + [i32] * 4 + [ptr]
        lib.moe_gating_fwd.restype = i32
        lib.moe_router_fwd.argtypes = [ptr, i32] + [ptr] * 4 + [i32] * 7 + [ptr]
        lib.moe_router_fwd.restype = i32
        lib.moe_router_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.moe_router_bwd.restype = i32
        lib.ssd_scan_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.ssd_scan_fwd.restype = i32
        lib.ssd_scan_bwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        lib.ssd_scan_bwd.restype = i32
        _lib = lib
    return _lib
