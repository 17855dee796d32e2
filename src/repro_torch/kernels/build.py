"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into a shared library (``csrc/*.cuh`` holds
device code that several sources include).  The library's file name
carries a hash of the source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  Libraries go to ``build/repro_torch/`` at
the root of the checkout (git-ignored).

A missing ``nvcc`` or a failed build raises: nothing gives way to the
plain PyTorch versions, which the wrappers take only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the repro_torch "
                       "CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together.  Returns each name's build seconds (0.0 if it was
    already built); raises with the compiler's output if one fails."""
    names = sources() if names is None else list(names)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    secs = dict.fromkeys(names, 0.0)
    if not todo:
        return secs
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def library_path(name: str) -> Path:
    """Where the shared library for ``csrc/<name>.cu`` is (or will be) built."""
    return _target(name)


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills, shared
    memory) from the build of ``name``, if it was built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned non-zero (-1: refused by the C side's own
    checks; otherwise a cudaError_t from ``cudaGetLastError``)."""
    if code == -1:
        raise ValueError(f"{what}: shape or dtype not supported by the kernel")
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
