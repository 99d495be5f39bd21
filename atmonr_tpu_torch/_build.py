"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. A build happens
at first use, into ``atmonr_tpu_torch/_build/`` (listed in ``.gitignore``),
under a file name that carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of the
package on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of atmonr_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source, headers and
    flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns (library path, compiler output); ``verbose`` has ``ptxas``
    report each kernel's registers, shared memory and spills."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
        "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_all(names: tuple[str, ...], verbose: bool = False) -> dict[str, tuple[Path, str]]:
    """``build`` for each name, one ``nvcc`` per source, all started
    together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(lambda n: build(n, verbose), names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
