"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file compiles into its own shared library with a plain C
interface, one ``nvcc`` process per file, all started together.  The
libraries land in ``build/repro_torch/<key>/`` at the repository root, where
``<key>`` is a hash of the sources and the flags, so an edited source builds
anew and an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with neither ``nvcc`` nor a card.

Floating point: ``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into
fused multiply-adds.  The kernels write ``__fmaf_rn`` by hand at exactly the
sites where XLA:CPU contracts the JAX reference, so their rounding matches it
bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "build_all", "function"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                           "CUDA kernels of repro_torch cannot be built")
    return str(path)


def source_key() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Tuple[Path, str]]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc each, in parallel.

    Returns ``{source stem: (library path, compiler log)}``; the log holds
    ``-Xptxas -v``'s registers and spills for a fresh build and is empty
    for a library that was already there.  Raises after every nvcc has
    ended if any of them failed.
    """
    out_dir = BUILD_DIR / source_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    result: Dict[str, Tuple[Path, str]] = {}
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        result[src.stem] = (lib, "")
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, lib, proc))
    failed = []
    for src, tmp, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
        result[src.stem] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def function(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built on first use.

    Its ``argtypes`` are set as given (``c_void_p`` for every pointer and
    the stream) and it returns the ``cudaError_t`` of its launch as an int.
    """
    key = (source, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        if source not in _LIBS:
            for stem, (path, _) in build_all().items():
                _LIBS.setdefault(stem, ctypes.CDLL(str(path)))
        fn = getattr(_LIBS[source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn
