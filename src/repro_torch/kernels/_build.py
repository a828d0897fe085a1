"""Build a CUDA source of the port into a shared library, at first use.

Route (b) of the port's kernel rule: ``nvcc`` compiles one ``csrc/*.cu``
file with a plain C interface into ``lib<name>.so``, which the kernel
module loads with ``ctypes``.  The library lands in
``<repo>/build/repro_torch/<name>-<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  The ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside the library as
``ptxas.log``.  Nothing here runs at import time: the CPU tests import the
kernel modules on a machine without ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["CSRC", "NVCC_FLAGS", "build_library"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME or /usr/local/cuda)")


def build_library(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.

    Returns ``(library path, ptxas report)``.  Concurrent builds (test
    workers, a CLI subprocess) each compile to a private file and rename
    it into place, so a reader never sees a half-written library.  Raises
    ``RuntimeError`` with the compiler's output when ``nvcc`` fails."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / f"{name}-{digest[:16]}"
    lib = out_dir / f"lib{name}.so"
    log = out_dir / "ptxas.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stdout}\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    tmp_log = out_dir / f".ptxas.{os.getpid()}.log"
    tmp_log.write_text(report)
    os.replace(tmp, lib)
    os.replace(tmp_log, log)
    return lib, report
