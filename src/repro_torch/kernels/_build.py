"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
Hopper (``sm_90a``) into ``csrc/build/`` at first use.  The file name carries
a hash of the source, of every header under ``csrc/`` (``*.cuh``) and of the
flags, so an edited kernel or header is rebuilt and a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source at once and waits for
all of them; each build keeps ``-Xptxas -v``'s report (registers, shared
memory, spills) beside its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("matmul", "tdfir", "flash_attention", "decode_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build every missing library (one ``nvcc`` per source, all started
    together) and return each kernel's ``-Xptxas -v`` report."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def on_device(dev):
    """A context that makes CUDA device ``dev`` current for a launch; a
    no-op (no device switch on the host) when it already is."""
    import torch
    if dev.index is None or dev.index == torch.cuda.current_device():
        return nullcontext()
    return torch.cuda.device(dev)


def raw_stream(dev) -> int:
    """The handle of the current CUDA stream on ``dev``, read without
    building a ``torch.cuda.Stream`` object (which costs a launch more host
    time than the handle alone)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(dev.index)
