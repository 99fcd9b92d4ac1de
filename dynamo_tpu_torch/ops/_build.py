"""Build and load the CUDA kernel library (the one place that runs nvcc).

Sources live in `dynamo_tpu_torch/csrc/`. At first use they are compiled
for sm_90a into `dynamo_tpu_torch/build/` — one `nvcc -c` per `.cu`, all
started together, then one link into a shared library with a plain C
interface that is loaded with `ctypes`. The library name carries a hash of
the sources and flags, so an edit rebuilds. A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from .kv_quant import kernel_operands

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build, if one ran


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    cand = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    paths = [os.path.join(cand, "bin", "nvcc")] if cand else []
    paths += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for p in paths:
        if p and os.path.isfile(p):
            return p
    raise KernelBuildError(
        "nvcc not found (looked at $CUDA_HOME, $PATH, /usr/local/cuda): the "
        "Hopper kernels are built from dynamo_tpu_torch/csrc at first use"
    )


def _sources():
    cu = sorted(CSRC_DIR.glob("*.cu"))
    hdr = sorted(CSRC_DIR.glob("*.cuh"))
    if not cu:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return cu, hdr


def _source_hash(cu, hdr, flags) -> str:
    h = hashlib.sha256()
    for p in cu + hdr:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _build(so_path: Path, cu) -> None:
    global build_seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = so_path.stem
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{tag}_{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, cmd, p in procs:
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
    link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log += f"\n$ {' '.join(link)}\n{res.stdout}"
    if res.returncode != 0:
        raise KernelBuildError(f"link failed:\n{build_log}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader never sees half a file
    for _, obj, _, _ in procs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if its hashed file is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cu, hdr = _sources()
        so_path = BUILD_DIR / f"libdynamo_hopper_{_source_hash(cu, hdr, NVCC_FLAGS)}.so"
        if not so_path.exists():
            _build(so_path, cu)
        lib = ctypes.CDLL(str(so_path))
        _declare(lib)
        _lib = lib
        return lib


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every C entry (pointers and the stream are
    c_void_p: ctypes would otherwise truncate them to 32-bit ints)."""
    # kv_k, kv_v, k_scale, v_scale, kv_bits, tables, max_pages, num_phys, strides
    kv = [_P, _P, _P, _P, _I, _P, _I, _I, _L, _L, _L]
    lib.dyn_paged_decode.argtypes = [
        _P, _P, *kv, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P]
    lib.dyn_paged_decode_local.argtypes = [
        _P, _P, *kv, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P]
    lib.dyn_prefill_attention.argtypes = [
        _P, _P, *kv, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.dyn_ragged_attention.argtypes = [
        _P, _P, *kv, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    for fn in (lib.dyn_paged_decode, lib.dyn_paged_decode_local,
               lib.dyn_prefill_attention, lib.dyn_ragged_attention):
        fn.restype = _I
    lib.dyn_error_string.argtypes = [_I]
    lib.dyn_error_string.restype = ctypes.c_char_p


# ---------------------------------------------------------------------- #
# argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------- #

_DTYPE_CODES = {"torch.bfloat16": 0, "torch.float32": 1}
HEAD_DIMS = (16, 64, 128)  # head_dim values the kernels are instantiated for
KV_FORMATS = ("none", "int8", "int4")  # keys of each wrapper's launches_by_format
_BITS_FORMAT = {0: "none", 8: "int8", 4: "int4"}


def dtype_code(q) -> int:
    code = _DTYPE_CODES.get(str(q.dtype))
    if code is None:
        raise TypeError(f"kernel takes bfloat16 or float32 queries, got {q.dtype}")
    return code


def check_dense(name: str, t, dtype=None) -> None:
    """A CUDA tensor, contiguous, 16-byte aligned (and of `dtype` if given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, is on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, is {t.dtype}")


def kv_args(q, kv_k_layer, kv_v_layer, page_tables, rows: int):
    """Validate one layer's KV operands (tensors, or per-layer QuantKV) and
    page tables against q [.., H, D]. Returns the C arguments (kv_k, kv_v,
    k_scale, v_scale, kv_bits, tables, max_pages, num_phys, s_page, s_tok,
    s_head), KH, page_size and the format's name."""
    check_dense("q", q)
    H, D = q.shape[-2], q.shape[-1]
    kv_k, kv_v, _, page_size, bits, k_scale, v_scale = kernel_operands(
        kv_k_layer, kv_v_layer)
    if kv_k.dim() != 4 or kv_k.shape != kv_v.shape or kv_k.stride() != kv_v.stride():
        raise ValueError("kv_k and kv_v must be [pages, rows, KH, D] and alike")
    num_phys, rows_held, KH, Dk = kv_k.shape
    if rows_held != (page_size // 2 if bits == 4 else page_size):
        raise ValueError(f"{rows_held} stored rows per page do not hold {page_size} "
                         f"tokens at kv_bits {bits}")
    want = q.dtype if bits == 0 else torch.int8
    if kv_k.dtype != want or kv_v.dtype != want:
        raise TypeError(f"KV pools must be {want} for q {q.dtype} and kv_bits {bits}, "
                        f"are {kv_k.dtype}/{kv_v.dtype}")
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} (KV {Dk}) not in {HEAD_DIMS}")
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if page_size % 4 or not (page_size <= 64 or page_size % 64 == 0):
        raise ValueError(f"page_size {page_size}: want a multiple of 4, <= 64 or a multiple of 64")
    if bits == 4 and not (page_size <= 64 or (page_size // 2) % 64 == 0):
        raise ValueError(f"int4 page_size {page_size}: want <= 64 or a multiple of 128")
    # 16-byte vectors of the pool's type; quantized rows are read 8 bytes
    # (bf16) or 4 bytes (f32) at a time
    vec = 16 // kv_k.element_size() if bits == 0 else 8
    s_page, s_tok, s_head, s_d = kv_k.stride()
    if s_d != 1 or s_page % vec or s_tok % vec or s_head % vec:
        raise ValueError(f"KV strides {kv_k.stride()} must keep D contiguous and rows aligned")
    for name, t in (("kv_k", kv_k), ("kv_v", kv_v), ("page_tables", page_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, is on {t.device}")
    if kv_k.data_ptr() % 16 or kv_v.data_ptr() % 16:
        raise ValueError("KV pools must be 16-byte aligned")
    scale_ptrs = (None, None)
    if bits:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            # read one f32 at a time: contiguous, no vector alignment needed
            if (sc.dtype != torch.float32 or sc.shape != (num_phys, KH)
                    or not sc.is_contiguous() or sc.device != q.device):
                raise ValueError(f"{name} must be contiguous f32 [{num_phys}, {KH}] "
                                 f"on {q.device}")
        scale_ptrs = (k_scale.data_ptr(), v_scale.data_ptr())
    check_dense("page_tables", page_tables, torch.int32)
    if page_tables.dim() != 2 or page_tables.shape[0] != rows:
        raise ValueError(f"page_tables must be [{rows}, max_pages], is {tuple(page_tables.shape)}")
    args = (kv_k.data_ptr(), kv_v.data_ptr(), *scale_ptrs, bits, page_tables.data_ptr(),
            page_tables.shape[1], num_phys, s_page, s_tok, s_head)
    return args, KH, page_size, _BITS_FORMAT[bits]


def check_index_vector(name: str, t, n: int, device) -> None:
    check_dense(name, t, torch.int32)
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"{name} must be int32 [{n}] on {device}")


def check_status(lib, rc: int, what: str) -> None:
    """Raise if a C entry reported a refused launch or unsupported input."""
    if rc != 0:
        msg = lib.dyn_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")
