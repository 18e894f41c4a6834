"""Build and load the CUDA kernel libraries of ``repro_torch/csrc``.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``. Nothing
here runs at import time: the first kernel launch builds, so the CPU tests
import every module without ``nvcc``. Libraries go to ``build/repro_torch/``
at the repository root, named by a hash of their sources, so an edited
source is rebuilt and an unchanged one is reused. All sources compile at
once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_SECONDS: dict = {}  # source stem -> seconds its nvcc took, for the fresh builds


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, else ``PATH``, else the
    toolkit PyTorch itself located. Raises when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    root = cpp_extension.CUDA_HOME
    if root and (Path(root) / "bin" / "nvcc").is_file():
        return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from source at first use")


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [source]:
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all at
    once. Returns {source stem: library path}; raises with the compiler's
    output when one fails. The compiler's resource report (``-Xptxas -v``)
    of each fresh build is kept beside its library as ``<lib>.log``, and
    the seconds each took in ``BUILD_SECONDS``."""
    nvcc = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        lib = _library_path(src)
        libs[src.stem] = lib
        if lib.is_file():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = tmp.with_name(tmp.name + ".log")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        with open(log, "w") as out:
            procs.append((src, lib, tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT)))
    failed = []
    while procs:
        for item in [p for p in procs if p[-1].poll() is not None]:
            procs.remove(item)
            src, lib, tmp, log, proc = item
            BUILD_SECONDS[src.stem] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc={proc.returncode}):\n{log.read_text()}")
                continue
            os.replace(log, lib.with_name(lib.name + ".log"))
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return ctypes.CDLL(str(build_all()[stem]))
