"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface. Nothing includes PyTorch's headers, so a
build takes under a minute. The library lands in ``.torch_kernels/<hash>/`` at the
root of the checkout (listed in ``.gitignore``), keyed by a hash of the
sources and of the headers they include (``csrc/*.cuh``), and is built at
first use: importing this module builds nothing.
``-Xptxas -v`` reports (registers, shared memory, spills) are kept in
``build.log`` beside the library. ``launch`` calls an entry point on a
card's current stream, the last argument of every entry point.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), ".torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    return os.path.join(BUILD_ROOT, _digest(_sources() + _headers()), "libtip_kernels.so")


def build() -> str:
    """Compile and link the kernels unless the library for these sources exists."""
    sources = _sources()
    out = library_path()
    if os.path.exists(out):
        return out
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        staged = os.path.join(tmp, "libtip_kernels.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", staged, *[obj for _, obj, _ in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
        os.replace(staged, out)
    return out


def build_log() -> str:
    """The compiler's report of the last build of the current sources."""
    path = os.path.join(os.path.dirname(library_path()), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every C function's signature declared."""
    lib = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tip_mnist_forward.restype = i
    lib.tip_mnist_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
    lib.tip_cifar10_forward.restype = i
    lib.tip_cifar10_forward.argtypes = [p] * 12 + [i, i, p]
    lib.tip_mnist_forward_bf16.restype = i
    lib.tip_mnist_forward_bf16.argtypes = [p, p, p, p, p, p, p, p, i, i, p]
    lib.tip_bf16_products.restype = i
    lib.tip_bf16_products.argtypes = [p, p, p, i, p]
    lib.tip_cifar10_forward_bf16.restype = i
    lib.tip_cifar10_forward_bf16.argtypes = [p] * 12 + [i, i, p]
    lib.tip_dsa_nearest.restype = i
    lib.tip_dsa_nearest.argtypes = [
        p, p, p, i, p, p, p, p, i, i, i, i, p, i, i, i, i, p, p, p, p, i, p, p, p, p, p,
    ]
    lib.tip_flash_attention_fwd.restype = i
    lib.tip_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
    lib.tip_flash_attention_fwd_bf16.restype = i
    lib.tip_flash_attention_fwd_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.tip_flash_attention_fwd_bf16_tile.restype = i
    lib.tip_flash_attention_fwd_bf16_tile.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
    lib.tip_flash_attention_bwd_dq.restype = i
    lib.tip_flash_attention_bwd_dq.argtypes = [p] * 7 + [i, i, i, i, i, f, p]
    lib.tip_flash_attention_bwd_dkv.restype = i
    lib.tip_flash_attention_bwd_dkv.argtypes = [p] * 8 + [i, i, i, i, i, f, p]
    return lib


def launch(index: int, fn, *args) -> int:
    """``fn(*args, stream)`` on card ``index``: that card current, its
    current stream last. The stream's raw handle and the current card are
    read without building Python objects, which cost microseconds that a
    training step's small launches feel."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
