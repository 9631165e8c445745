"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call builds it in seconds. The shared library goes into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``) under a name that carries the hash of the source, the
headers it may include (``csrc/*.cuh``) and the flags: an edited source or
header builds anew, an unchanged one is loaded as it is.
Nothing is built when a module is imported, only at a kernel's first launch
or through ``build``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    return found


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` goes, keyed by its content and
    that of every header in ``csrc/``."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name):
    """Build ``csrc/<name>.cu`` with one nvcc call if its library is stale.
    Returns (library path, seconds, ptxas report); seconds are 0 and the
    report empty when the library was already built. Raises with nvcc's
    output if the build fails."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0, proc.stdout


def build_all(names):
    """``build`` for several sources, their nvcc calls started together.
    Returns {name: (library path, seconds, ptxas report)}, each call's
    seconds its own."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.cache
def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if stale."""
    lib, _, _ = build(name)
    return ctypes.CDLL(str(lib))
