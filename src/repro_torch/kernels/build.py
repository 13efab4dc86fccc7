"""Build the port's CUDA sources with ``nvcc`` on first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so a
build takes seconds. The library goes to ``<repo>/build/kernels/`` under a
name keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags; a second process finds it there, and an edited source or header
builds anew. :func:`build_all` runs one ``nvcc`` per source, all at once.
Nothing is built at import time: the CPU tests import every module, and a
build runs only when a CUDA tensor reaches a kernel wrapper.

A failed build raises; there is no fallback to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from source on first use")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists. Returns
    ``(library path, compiler log, seconds spent)``; the log holds
    ``-Xptxas -v``'s register and shared-memory report."""
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.is_file():
        return out, log_path.read_text() if log_path.is_file() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        log_path.write_text(log)
        os.replace(tmp_out, out)      # atomic: a racing process sees all or none
    return out, log, time.perf_counter() - t0


def build_all(names) -> dict:
    """:func:`build` for every name, one ``nvcc`` process per source, all
    started together. Returns ``{name: (path, log, seconds)}``; raises the
    first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
