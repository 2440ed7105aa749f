"""Build and load the hand-written Hopper kernels (csrc/*.cu).

The kernels are compiled with nvcc from the package's own sources, one nvcc
process per source file, all started together, then linked into one shared
library with a plain C interface, on first use, into `_build/` next to the
package (listed in .gitignore), and bound with ctypes. The library
name carries a hash of the sources, so an edited kernel is rebuilt and a
stale build is never loaded. Nothing here runs at import time: the CPU
tests import every module of the port on a machine without nvcc.

There is no fallback. Without nvcc, or on a card other than sm_90, loading
raises; a wrapper handed a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel an entry with a `route` out-parameter reports it ran; 5 and 6 are
# the normalise-first kernels that hold a head's K and V in shared memory
ROUTES = {0: "fma", 1: "mma_sync", 2: "wgmma", 3: "narrow", 4: "wide", 5: "wgmma_resident", 6: "mma_sync_resident"}


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_FAILED_BUILDS = {}  # library path -> the compiler's errors, so a failed build is not repeated


def build() -> str:
    """Compile csrc/*.cu into _build/ (skipped when this source hash is
    already built): one nvcc per source in parallel, then one link. Returns
    the library path; the compilers' output, with ptxas's register and
    spill report, is kept in _build/build.log. A failed build raises, and
    raises again at once on every later call in the process."""
    lib_path = os.path.join(BUILD_DIR, f"libvidseg_kernels-{_source_hash()}.so")
    if os.path.isfile(lib_path):
        return lib_path
    if lib_path in _FAILED_BUILDS:  # the same sources would fail the same way, a minute later
        raise RuntimeError(_FAILED_BUILDS[lib_path])
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc was not found on PATH, in "
            "$CUDA_HOME/bin or in /usr/local/cuda/bin. The PyTorch port has no "
            "fallback for CUDA tensors; CPU tensors use the plain versions."
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    log, errors = [], []
    t0 = time.perf_counter()
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"{' '.join(cmd)}\n[done after {time.perf_counter() - t0:.1f} s]\n{out}{err}")
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    if not errors:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            errors.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    if errors:
        _FAILED_BUILDS[lib_path] = "nvcc failed: " + "\n".join(errors)
        raise RuntimeError(_FAILED_BUILDS[lib_path])
    os.replace(tmp, lib_path)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

_SIGNATURES = {
    # dtype, D, q, k, v, o, lse (NULL: none), B, H, Lq, Lk, strides[12], qscale,
    # sum_mode (0: the denominator sums the fp32 p, 1: the rounded p, 2: p is
    # normalised in fp32 before it is rounded; qscale then multiplies the fp32
    # logits; 3: as 2 on the kernel that streams the keys), route (int*: the
    # kernel that ran, ROUTES), stream
    "vs_flash_attention_packed": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P],
    # the same arguments, bhld strides
    "vs_flash_attention_bhld": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P],
    # dtype, D, q, k, v, o, g, lse, scratch (fp32 [2, B*H, Lq rounded up to 4]), dq,
    # dk, dv, B, H, Lq, Lk, strides[24], qscale, scale, route (int*), stream
    "vs_flash_attention_packed_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _P, _F, _F, _P, _P],
    # the same arguments, bhld strides
    "vs_flash_attention_bhld_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _P, _F, _F, _P, _P],
    # dtype, D, q, k, v, o, nvid, t, S, H, qscale, route (int*), stream
    "vs_temporal_attention_direct": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    # dtype, D, q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, route (int*), stream
    "vs_temporal_attention_direct_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _F, _F, _P, _P],
    # dtype, x, w [kt, Cout, Cin], bias (NULL: none), y, B, T, M, Cin, Cout, kt, route (int*), stream
    "vs_temporal_conv_1x1": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # dtype, x, partial, counters, gamma, beta, wdtype, a, s, mean, inv, B, R, C, G, vec,
    # rows_per_chunk, nchunks, eps, stream
    "vs_group_norm_stats": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _P],
    # dtype, x, gamma, beta, wdtype, y, a, s, mean, inv, B, R, C, G, groups per block, eps, silu, stream
    "vs_group_norm_fused": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # dtype, x, a, s, y, B, R, C, vec, rows_per_chunk, nchunks, silu, stream
    "vs_group_norm_apply": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, dy, a, s, gamma, wdtype, mean, inv, dx, dparam scratch, counters, dgamma, dbeta,
    # B, R, C, G, groups per slab, cluster size, rows per block, rows per box, silu, stream
    "vs_group_norm_bwd_slab": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, cluster size, shared memory a block, placed (int*: blocks or clusters the device holds)
    "vs_group_norm_bwd_slab_placement": [_I, _I, _I, _P],
    # dtype, x, dy, a, s, partial, counters, gamma, wdtype, mean, inv, coef, dparam scratch, dgamma,
    # dbeta, B, R, C, G, vec, rows_per_chunk, nchunks, silu, stream
    "vs_group_norm_bwd_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, dy, a, s, coef, dx, B, R, C, vec, rows_per_chunk, nchunks, silu, stream
    "vs_group_norm_bwd_apply": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, w [N, K], bias (NULL: none), y, M, K, N, route (int*), stream
    "vs_matmul_bias": [_I, _P, _P, _P, _P, _L, _I, _I, _P, _P],
    # dtype, x, w [9, Cout, Cin], bias (NULL: none), y, B, H, W, Cin, Cout, stream
    "vs_conv3x3_same": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises when it cannot."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.vs_error_string.argtypes = [_I]
    lib.vs_error_string.restype = ctypes.c_char_p
    return lib


def check_cuda_tensors(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Device/dtype checks shared by the wrappers: every tensor on one CUDA
    device, one dtype out of float32/bfloat16. Returns the dtype."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    return dtype


def call(name: str, *args) -> None:
    """Invoke a kernel entry point on the current stream; raise on a nonzero
    return (a refused launch or an argument the kernel was not built for)."""
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.vs_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: {msg} (code {rc})")


def call_routed(name: str, *args) -> str:
    """`call` for an entry whose last argument before the stream is an int*
    that receives the kernel it ran; returns that kernel's ROUTES name."""
    route = ctypes.c_int(-1)
    call(name, *args, ctypes.byref(route))
    return ROUTES[route.value]


def strides_arg(*tensors: torch.Tensor, dims=(0, 1, 2)):
    """Pack (batch, row, head) element strides of each 4-D tensor for the
    flash kernels (forward and backward); the last (head-dim) stride must
    be 1."""
    vals = []
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("flash kernels need a unit stride on the head dim")
        vals.extend(int(t.stride(d)) for d in dims)
    return (ctypes.c_longlong * len(vals))(*vals)
