"""Build and load the port's CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which
``ctypes`` loads. Nothing includes PyTorch's headers, so a build takes
seconds. Libraries land in ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of their source and flags, and
are built at first use: importing this module compiles nothing.

Every C entry point returns a ``cudaError_t`` as an int; ``check`` turns a
non-zero value into a ``RuntimeError``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_prefill", "decode_attention", "paged_attention",
           "chunk_prefill", "rwkv6_scan", "rwkv6_scan_bwd", "moe_experts")

_lock = threading.Lock()
_libs: dict = {}        # name -> loaded CDLL
_fns: dict = {}         # (name, entry point) -> bound C function
# per-source build record: {"seconds", "ptxas", "path"}
build_log: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    src = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    src += (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (no wait). Returns (path, proc|None)."""
    path = _lib_path(name)
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, (proc, tmp, time.time())


def _finish(name: str, path: Path, pending):
    report = path.with_suffix(".ptxas.txt")  # nvcc's -Xptxas -v output
    if pending is None:
        build_log.setdefault(name, {
            "seconds": 0.0, "path": str(path),
            "ptxas": report.read_text() if report.exists() else "(cached)"})
        return
    proc, tmp, t0 = pending
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    report.write_text(out)
    os.replace(tmp, path)
    build_log[name] = {"seconds": time.time() - t0, "ptxas": out,
                       "path": str(path)}


def build_all(names=SOURCES) -> dict:
    """Compile every named source at once, one nvcc process each, all
    started together. Returns ``build_log``."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        for n, path, pending in started:
            _finish(n, path, pending)
    return build_log


def load(name: str, fn: str, argtypes):
    """The C entry point ``fn`` of csrc/<name>.cu (built if needed), with
    its ``argtypes`` set and an int (``cudaError_t``) result."""
    f = _fns.get((name, fn))
    if f is not None:
        return f
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_log[name]["path"])
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        f = getattr(_libs[name], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return f


def check(name: str, err: int, what: str):
    if err != 0:
        msg = _libs[name].kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
# head dims the attention kernels (K1-K5) are instantiated for:
# TEOLA_DISPATCH in csrc/common.cuh
HEAD_DIMS = (64, 128, 256)


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


_shape_only = threading.local()


@contextlib.contextmanager
def shape_only():
    """Inside this block a wrapper given meta tensors runs its kernel's
    plain version, which on meta computes only shapes: the dry run's pass
    over one rank's shards. Outside it a meta tensor is refused like any
    device other than the CPU and CUDA."""
    prev = getattr(_shape_only, "on", False)
    _shape_only.on = True
    try:
        yield
    finally:
        _shape_only.on = prev


def plain_device(t) -> bool:
    """Whether a wrapper given ``t`` runs its kernel's plain version: a CPU
    tensor, or a meta tensor inside ``shape_only``. A CUDA tensor launches
    the kernel; any other device raises."""
    return t.device.type == "cpu" or (
        t.device.type == "meta" and getattr(_shape_only, "on", False))
