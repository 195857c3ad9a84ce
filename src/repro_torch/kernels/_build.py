"""Build the port's CUDA sources into one shared library, at first use.

Every ``src/repro_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process (all started together) for ``sm_90a``, and the objects are linked
into ``build/repro_torch/<hash>/librepro_torch_kernels.so`` at the root of
the checkout.  ``<hash>`` digests the sources and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is.  The library has
a plain C interface and is loaded with ``ctypes``; its functions launch on
the stream they are given and return ``cudaGetLastError()``.

``--use_fast_math`` is deliberately absent: ``expf``, ``tanhf`` and the
division of eq. 14 must round like the plain versions.
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
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: Dict[str, object] = {}


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile and link the library unless it exists.  Returns its path
    and the compilers' output (``-Xptxas -v`` register and shared-memory
    report when ``verbose``)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    tmp = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        out_so = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out_so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed\n" + link.stdout)
        os.replace(out_so, lib)
        return lib, "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The built library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = ctypes.CDLL(str(path))
        return _lib


def function(name: str, argtypes: Sequence) -> object:
    """A C function of the library with its ``argtypes`` declared and an
    ``int`` (the CUDA error code) as its result."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn

