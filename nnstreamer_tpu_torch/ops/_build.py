"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, which is loaded with ``ctypes``. Nothing here includes
PyTorch's headers, so a build takes seconds.

Libraries go to ``build/torch_kernels/`` at the root of the checkout,
named by a hash of their source, so an edited
source is rebuilt and an unchanged one is loaded as it is. A build runs at
first use, inside the call that needs the kernel; :func:`build_all`
compiles every source at once, one ``nvcc`` for each, started together.
``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME`` and
``/usr/local/cuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_ptr, _int, _ll, _float = (ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_float)
# C signature of each library's entry points: name -> (restype, argtypes)
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "attention": {
        "nns_attention_fwd": (_int, [_ptr, _ptr, _ptr, _ptr, _int, _int,
                                     _int, _int, _int] + [_ll] * 12
                              + [_float, _ptr]),
        "nns_cuda_error_string": (ctypes.c_char_p, [_int]),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (PATH, $CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libnns_{name}-{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every missing library of ``names`` in parallel; returns
    each library's compiler output (ptxas register and shared-memory
    report), "" for one already built. Raises if any build fails."""
    todo: List[Tuple[str, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        lib = library_path(name)
        if lib.exists():
            logs[name] = ""
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        todo.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, proc in todo:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(lib.with_suffix(f".tmp{os.getpid()}"), lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return _loaded[name]
