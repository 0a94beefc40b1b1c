"""Build and load the CUDA kernels of ``lighthouse_tpu_torch/csrc``.

Each ``csrc/k_*.cu`` compiles with nvcc into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes).  All sources compile at once, one nvcc process each,
at first use; the libraries go to ``lighthouse_tpu_torch/build/<key>/``,
keyed on a hash of every source and the flags, so an edited source is never
served stale.  A failed build raises ``BuildError`` with nvcc's output.

Each C entry takes its pointers and the stream as ``void*`` (ctypes
``c_void_p``; a plain int argument would be cut to 32 bits) and returns
``cudaGetLastError()``; ``call`` raises ``KernelError`` when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "build")
KERNELS = ("k_xmd", "k_hash", "k_points", "k_pair", "k_decode", "k_each",
           "k_arena", "k_sign", "k_sha256", "k_epoch", "k_kzg", "k_verify",
           "k_ring")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class BuildError(RuntimeError):
    pass


class KernelError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or NVCC)")


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {}   # per kernel: seconds, ptxas lines (a cached
                        # library's from its build log), cached


def _parse_ptxas(text: str) -> list:
    """The ptxas lines that give registers, stack frames and spills."""
    return [ln.strip() for ln in text.splitlines()
            if re.search(r"registers|spill|stack frame", ln)]


def _read_log(out_dir: str, name: str) -> str:
    path = os.path.join(out_dir, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build_log(name: str) -> str:
    """nvcc's whole output for kernel ``name`` of the current sources: the
    ptxas lines with the functions they belong to ("" before a build)."""
    return _read_log(os.path.join(BUILD_ROOT, source_key()), name)


def ptxas_functions(text: str) -> dict:
    """Per function of a build log (mangled name): registers, stack frame,
    spill bytes and, where ptxas prints it, the cumulative stack size."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)'?", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack_frame"] = int(m.group(1))
            cur["spill"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes cumulative stack size", ln)
        if m:
            cur["cumulative_stack"] = int(m.group(1))
    return funcs


def build_all() -> dict:
    """Compile every kernel that is not built yet for the current sources,
    all nvcc processes at once; returns BUILD_INFO."""
    with _LOCK:
        if len(_LIBS) == len(KERNELS):
            return BUILD_INFO
        key = source_key()
        out_dir = os.path.join(BUILD_ROOT, key)
        os.makedirs(out_dir, exist_ok=True)
        procs = {}
        for name in KERNELS:
            so = os.path.join(out_dir, f"lib{name}.so")
            if os.path.exists(so):         # its log is written before it
                BUILD_INFO[name] = {"seconds": 0.0, "cached": True,
                                    "ptxas": _parse_ptxas(_read_log(
                                        out_dir, name))}
                continue
            tmp = so + f".tmp{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so, time.perf_counter())
        failed = []
        for name, (proc, tmp, so, started) in procs.items():
            out, _ = proc.communicate()
            secs = time.perf_counter() - started
            with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name} (rc {proc.returncode}):\n{out[-4000:]}")
                continue
            os.replace(tmp, so)
            BUILD_INFO[name] = {"seconds": round(secs, 3), "cached": False,
                                "ptxas": _parse_ptxas(out)}
        if failed:
            raise BuildError("nvcc failed for " + "\n".join(failed))
        for name in KERNELS:
            _LIBS[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        return BUILD_INFO


def lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def call(name: str, entry: str, *args) -> None:
    """Call a C entry of kernel library `name`: tensors pass as their data
    pointers, ints as c_int, None as NULL; the current stream of the first
    tensor's device goes last, and the call runs with that device current
    (a mesh may span several cards)."""
    call_lib(lib(name), name, entry, *args)


def call_lib(handle: ctypes.CDLL, name: str, entry: str, *args) -> None:
    """``call`` on a loaded library (``name`` labels its errors)."""
    import torch

    fn = getattr(handle, entry)
    cargs, device = [], None
    for a in args:
        if a is None:
            cargs.append(ctypes.c_void_p(None))
        elif isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
            device = a.device if device is None else device
        elif isinstance(a, int):
            cargs.append(ctypes.c_int(a))
        else:
            raise TypeError(f"{name}.{entry}: unsupported argument {a!r}")
    with torch.cuda.device(device):
        cargs.append(ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
        fn.restype = ctypes.c_int
        fn.argtypes = [type(c) for c in cargs]
        rc = fn(*cargs)
    if rc != 0:
        raise KernelError(f"{name}.{entry} failed: cudaError {rc}")
