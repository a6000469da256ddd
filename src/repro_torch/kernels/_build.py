"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into ONE shared library with a plain
C interface, and loaded with ``ctypes``. The build runs at first use, into
``src/repro_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the sources and flags so an edited source rebuilds. Nothing is built when a
module is imported: the CPU tests import every module and there is no
``nvcc`` there.
"""
from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass
class BuildInfo:
    library: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas_log: str  # what `-Xptxas -v` printed (registers, shared memory, spills)


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _key(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*sources, *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile (or reuse) the kernel library. Raises on any compiler error."""
    global _info
    if _info is not None:
        return _info
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_DIR / _key(sources)
    lib_path = out_dir / "librepro_kernels.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder at a time per key
        if lib_path.exists():
            log = (out_dir / "ptxas.log").read_text() if (out_dir / "ptxas.log").exists() else ""
            _info = BuildInfo(lib_path, 0.0, log)
            return _info
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for src in sources:
            obj = out_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = out_dir / f"tmp{os.getpid()}.so"
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp, lib_path)
        _info = BuildInfo(lib_path, time.perf_counter() - t0, "\n".join(logs))
        return _info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().library))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library; every entry point returns the
    ``cudaError_t`` of its launch as an int."""
    if name not in _functions:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]


def check(err: int, what: str) -> None:
    """Raise if a launch reported an error (``cudaGetLastError`` != 0)."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


P = ctypes.c_void_p  # device pointer / stream
I = ctypes.c_int
F32 = ctypes.c_float

_validated = set()


def validate_once(tag, tensors, check) -> None:
    """Run ``check()``, which raises on whatever a kernel does not take, once
    per ``tag`` and (shape, stride, dtype, device) of ``tensors`` (``None``
    for an absent optional tensor); later calls with the same key skip it.
    What can change between calls with one key (a host integer such as the
    log tail, a base address) the wrapper checks on every call."""
    key = (tag, *[None if t is None else (t.shape, t.stride(), t.dtype, t.get_device()) for t in tensors])
    if key not in _validated:
        check()
        _validated.add(key)


def expect(what: str, device, *checks) -> None:
    """Raise unless each (name, tensor, shape, dtype) matches, lies on
    ``device`` and is contiguous (``what`` names the kernel)."""
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"want {tuple(shape)} {dtype} {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def plain(t: torch.Tensor, op: str) -> bool:
    """How a wrapper chooses by ``t``'s device type: True on ``cpu`` and
    ``meta`` (the plain version: the CPU tests, and the dry run, which counts
    the work with no data), False on ``cuda`` (the kernel, always). Any other
    device raises."""
    kind = t.device.type
    if kind not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{op}: no version for tensors on {t.device}")
    return kind != "cuda"
