"""Build a hand-written CUDA kernel with ``nvcc`` and load it with ``ctypes``.

Each kernel is one ``.cu`` source with a plain C interface.  It is
compiled for ``sm_90a`` at first use into ``build/repro_torch/`` at the
root of the checkout, under a name that carries a hash of the source and
the flags, so an edited source is rebuilt.  Builds of several sources may
run at once (each in its own process): a build writes a temporary file and
moves it into place atomically.
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
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc(src: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found: the {src.stem} CUDA kernel "
                           "is compiled at first use and needs the CUDA "
                           "toolkit (set CUDA_HOME)")
    return str(path)


def library_path(src: Path, flags: tuple[str, ...]) -> Path:
    """Where the built kernel lives; the name carries a hash of the source
    and the flags, so an edited source is rebuilt."""
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, flags: tuple[str, ...]) -> tuple[Path, float, str]:
    """Compile ``src`` with ``flags`` unless it is built already.  Returns
    (library, seconds spent compiling, ptxas report)."""
    lib = library_path(src, flags)
    if lib.exists():
        return lib, 0.0, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(src), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(src: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """The built library, loaded once per process; the caller declares
    ``argtypes`` and ``restype`` of the functions it calls."""
    return ctypes.CDLL(str(build(src, flags)[0]))
