"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface (pointers and the
stream as ``void*``), so it compiles in seconds without PyTorch's headers.
Libraries go to ``build/kernels/`` beside the package, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags: a changed
source or header builds anew, an unchanged one is loaded as it is.  The
build runs at first use; :func:`build_all` starts one ``nvcc`` per source,
all at once.  :func:`launch` runs a C entry point of a library on a
device's current stream and counts it (``utils/observe.py``): every kernel
wrapper of the port goes through it.

Nothing here is imported or compiled when the package is imported: the
CPU tests import every module, and this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from ..utils.observe import launch_counts

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "library", "entry",
           "launch", "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"gn_silu": "gn_silu.cu", "flash_attn": "flash_attn.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "flash_attn_bwd_sm90": "flash_attn_bwd_sm90.cu", "adamw_ema": "adamw_ema.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    """``build/kernels/`` at the root of the checkout (listed in .gitignore)."""
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "CUDA kernels cannot be built on this machine")
    return cand


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header (``csrc/*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Build every source that is not built yet, one ``nvcc`` process per
    source, started together.  Raises with the compiler's output when one
    fails.  Returns ``{name: path of the shared library}``."""
    out = {name: _target(name) for name in SOURCES}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source ``name``, built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def entry(lib: str, name: str, argtypes: Sequence[type]) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of kernel source ``lib``, returning an
    ``int`` (a ``cudaError_t``), its arguments declared as ``argtypes``:
    pointers and the stream as ``c_void_p``, so that ctypes never cuts
    them to 32 bits.  Bound once per process."""
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _entries[lib, name] = fn
    return fn


def launch(lib: str, name: str, argtypes: Sequence[type], device: torch.device,
           args: Sequence, key: str) -> None:
    """Call entry ``name`` of ``lib`` with ``args`` and, last, ``device``'s
    current stream, and count it in ``launch_counts`` under ``key``
    (``"<op>.<route>"``); raise ``RuntimeError`` naming the entry and its
    key on a non-zero return code."""
    fn = entry(lib, name, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({key}) kernel launch failed: cudaError {rc}")
    launch_counts[key] += 1


def ptxas_report() -> List[str]:
    """The register, shared-memory and spill lines ``ptxas -v`` printed
    for every built kernel (after :func:`build_all`)."""
    lines = []
    for name in SOURCES:
        log = _target(name).with_suffix(".log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                    lines.append(f"{SOURCES[name]}: {ln.strip()}")
    return lines
