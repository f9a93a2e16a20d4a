"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
compiles in seconds into ``<package>/_build/<name>-<hash>.so``. The hash
covers the source and the flags, so an edited source builds anew. Builds
run at first use, never at import: the CPU tests import every module on
hosts without ``nvcc``. Two processes building at once each write a
private temporary file and rename it into place, which is atomic.

No fallback: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# -fmad=false: the kernels mirror a plain PyTorch version that rounds every
# f32 op; FMA contraction moves ulp-boundary texels against it (the warp
# kernel's note). No --use_fast_math: divisions and sqrt stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_LIBS: Dict[tuple, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}   # name -> seconds of its nvcc run
BUILD_LOG: Dict[str, str] = {}         # name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str, flags) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str], flags=NVCC_FLAGS) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Returns name -> shared library path."""
    targets = {n: _target(n, flags) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, t in todo.items():
        tmp = t.with_name(f"{t.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(),
                    subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, t0, p) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get((name, flags))
    if lib is None:
        path = build([name], flags)[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[(name, flags)] = lib
    return lib
