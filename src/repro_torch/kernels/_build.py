"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library named by a hash of the sources and flags, under
``kernels/build/``. The first call to :func:`library` builds (or finds
an existing build) and loads it; later calls return the loaded library.
The sources include no PyTorch header and export a plain C interface, so
a build takes seconds rather than the minutes a PyTorch extension would.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception, because a refused
launch never runs and a later synchronise would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: ``sm_90a`` (not ``sm_90``): the Hopper target with ``wgmma`` and
#: ``setmaxnreg``.
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              *ARCH_FLAGS]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDED = [_P, _L, _L, _L, _L]   # data pointer, then (B, H, S, D) strides

#: C entry points and their argument types (pointers and the stream as
#: ``c_void_p`` so ctypes never truncates them to 32 bits).
SIGNATURES: Dict[str, List[type]] = {
    # Each matrix operand is its data pointer, then its batch, row and
    # column strides; batch is the number of instances (1 for one product).
    # a, b (strided), c, workspace, batch, m, n, k, config, split, kchunk,
    # stream
    "repro_gemm_f32": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _L, _I, _I, _I,
                       _I, _I, _I, _P],
    # a (strided), c, workspace, batch, m, k, config, split, kchunk, stream
    "repro_syrk_f32": [_P, _L, _L, _L, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # s, b (strided), c, workspace, batch, m, n, config, split, kchunk,
    # stream
    "repro_symm_f32": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _L, _I, _I, _I,
                       _I, _I, _P],
    # a, b, c (strided), out, batch, m, k, l, n, config, stream
    "repro_chain_gemm_f32": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L,
                             _P, _L, _I, _I, _I, _I, _I, _P],
    # a, b (strided), out, batch, m, k, l, bl, cluster, stream
    "repro_gemm_syrk_f32": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _I, _I,
                            _I, _I, _I, _P],
    # m, bl, cluster, count (out)
    "repro_gemm_syrk_max_clusters": [_I, _I, _I,
                                     ctypes.POINTER(ctypes.c_int)],
    # dtype, head_dim, q, k, v, o (each strided), batch, heads, kv_heads,
    # seq, scale, softcap, causal, window, stream
    "repro_flash_attention": [_I, _I, *(_STRIDED * 4), _I, _I, _I, _I,
                              _F, _F, _I, _I, _P],
    # dtype, x, b, c (each a pointer and its batch, chunk, position and
    # head strides), dt, cum, w, y, s, batch, chunks, q, heads, groups, n,
    # p, stream
    "repro_ssd_chunk_fwd": [_I, *([_P, _L, _L, _L, _L] * 3), *[_P] * 5,
                            *[_I] * 7, _P],
    # dtype, x, b, c (strided), dt, cum, w, y, dy, ds, dx, db, dc, ddt,
    # dcum, dw, two scratch buffers, batch, chunks, q, heads, groups, n, p,
    # head slices, stream
    "repro_ssd_chunk_bwd": [_I, *([_P, _L, _L, _L, _L] * 3), *[_P] * 14,
                            *[_I] * 8, _P],
    # head_dim, q, k, v (each a pointer and its batch, position and head
    # strides), o, o32, lse, batch, heads, kv_heads, seq, scale, softcap,
    # causal, window, stream
    "repro_flash_train_fwd": [_I, *([_P, _L, _L, _L] * 3), _P, _P, _P,
                              *[_I] * 4, _F, _F, _I, _I, _P],
    # head_dim, q, k, v (strided), o32, lse, dout (strided), delta, dq, dk,
    # dv, then as the forward
    "repro_flash_train_bwd": [_I, *([_P, _L, _L, _L] * 3), _P, _P,
                              _P, _L, _L, _L, *[_P] * 4, *[_I] * 4, _F, _F,
                              _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source, header and flag that goes into the build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{source_hash()}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists.

    Each build works in its own temporary directory and moves the
    finished library into place atomically, so concurrent builders never
    load a half-written file. The compiler's resource report
    (``-Xptxas=-v``: registers, shared memory, spills) is kept beside the
    library as ``<name>.log``.
    """
    target = library_path()
    if target.is_file():
        return target
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        linked = tmp / target.name
        link = subprocess.run(
            [compiler, "-shared", *ARCH_FLAGS,
             *(str(obj) for _, obj, _ in procs), "-o", str(linked)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(linked, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def matrix_args(*tensors: torch.Tensor) -> list:
    """Each operand as the C entry points take it: its data pointer, then
    its batch, row and column strides (a matrix's batch stride is 0)."""
    args = []
    for t in tensors:
        st = t.stride()
        args += (t.data_ptr(), 0, *st) if len(st) == 2 else (t.data_ptr(), *st)
    return args


def stream(device: torch.device | int) -> int:
    """Handle of PyTorch's current stream on ``device``, read without
    making a ``torch.cuda.Stream`` object (a few microseconds a launch)."""
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
