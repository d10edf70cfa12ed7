"""Build the port's CUDA sources (``csrc/*.cu``) and load them with ctypes.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, under ``build/kernels/`` at the repository root,
named by a hash of the sources and flags so that an edited source is
rebuilt and an unchanged one is not.  :func:`build` starts one ``nvcc``
per source, all together, and waits for every one.  A failed build
raises with the compiler's log; nothing falls back to the plain twins.

Building happens at first use (or in ``chip_smoke.py``'s build phase),
never when a module is imported, so the CPU tests import everything on
a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas -v writes each kernel's registers and shared memory to the log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the sources' hash."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> list[str]:
    """Compile every named source (default: all of ``csrc/*.cu``) that
    has no library yet, one ``nvcc`` each, started together.  Returns
    the names that were compiled."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = out.with_suffix(".log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
        jobs.append((name, proc, tmp, out, log_path))
    failed = []
    for name, proc, tmp, out, log_path in jobs:
        if proc.wait() == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"nvcc failed for {name}:\n{log_path.read_text()}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return todo


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (registers, shared memory)."""
    log_path = library_path(name).with_suffix(".log")
    return log_path.read_text() if log_path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
