"""Build, load and count the hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled with `nvcc` for `sm_90a` into one shared library
with a plain C interface, `build/ethrex_tpu_torch/libethrex_kernels.so`
under the checkout, at first launch (never at import, so the package
imports on a machine without CUDA).  Each source compiles in its own
`nvcc` process, all started together, and the objects are linked once.
The library is rebuilt only when a hash of the sources changes.

Generated kernels (the AIR constraint kernels of `stark/air_codegen.py`)
are built the same way into a library of their own per source text,
`build/ethrex_tpu_torch/air/lib<hash>.so`, by `load_generated`
(`build_generated` compiles several at once).

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right
where it launches, and nowhere else; `reset_launches()` zeroes the counts
so a caller can show which kernels a run went through.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ethrex_tpu_torch"
LIB_NAME = "libethrex_kernels.so"

# kernel name -> its source in the package; LAUNCHES counts its launches
KERNELS = {
    "ntt": "csrc/ntt.cu",
    "poseidon2_hash_leaves": "csrc/poseidon2.cu",
    "poseidon2_compress_level": "csrc/poseidon2.cu",
    "mod_matmul": "csrc/mod_matmul.cu",
    "fri_fold": "csrc/fri_fold.cu",
    "air_constraints": "stark/air_codegen.py",
    "batch_inv": "csrc/batch_inv.cu",
    "bn254_msm_g1": "csrc/bn254_msm.cu",
    "bn254_msm_g2": "csrc/bn254_msm.cu",
    "deep_compose": "csrc/deep_compose.cu",
    "quotient_combine": "csrc/quotient_combine.cu",
    "merkle_batched_level": "csrc/poseidon2.cu",
    "ext_poly_eval": "csrc/ext_poly_eval.cu",
}
LAUNCHES = {name: 0 for name in KERNELS}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile every `csrc/*.cu` (one nvcc each, in parallel) and link
    them into the shared library; a no-op when the source hash matches
    the last build.  Raises on any compiler error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "source_hash"
    digest = _source_hash()
    if lib_path.exists() and stamp.exists() and \
            stamp.read_text().strip() == digest:
        return lib_path
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    objs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{text}")
        elif verbose and text.strip():
            print(f"[nvcc {src.name}]\n{text}", flush=True)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry -> argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "ntt_prepare": [_P, _P, _P, _L, _L, _L, _I, _I, _P],
    "ntt_stages": [_P, _P, _L, _I, _P],
    "ntt_scale": [_P, _P, _L, _I, _I, _P],
    "p2_set_constants": [_P, _P, _P],
    "p2_hash_leaves": [_P, _P, _L, _I, _L, _L, _I, _L, _P],
    "p2_compress_level": [_P, _P, _L, _P],
    "mod_matmul_rows": [_P, _P, _P, _L, _L, _I, _L, _L, _I, _P],
    "mod_matmul_splitk": [_P, _P, _P, _P, _L, _L, _I, _L, _L, _I, _I, _P],
    "fri_fold": [_P, _P, _P, _P, _P, _L, _P],
    "batch_inv": [_P, _P, _L, _I, _P],
    "bn254_msm": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "deep_compose": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "quotient_combine": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "p2_batched_level": [_P, _P, _P, _I, _L, _P],
    "ext_powers_table": [_P, _P, _P, _L, _I, _P],
    "ext_poly_eval": [_P, _L, _L, _L, _P, _P, _I, _L, _I, _I, _P, _P, _P],
}


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


GEN_DIR = BUILD_DIR / "air"
# source hash -> nvcc wall seconds, for the generated sources built by
# this process
GENERATED_BUILD_S: dict = {}
_generated: dict = {}


def _generated_key(text: str) -> str:
    h = hashlib.sha256(text.encode())
    h.update((CSRC / "babybear.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_generated(texts: list[str], verbose: bool = False) -> list[Path]:
    """Compile generated CUDA sources (one nvcc each, all started
    together) into `GEN_DIR/lib<hash>.so`; a source already built is
    skipped.  Raises on any compiler error."""
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    extra = ["-Xptxas", "-v"] if verbose else []
    procs, paths = [], []
    for text in texts:
        key = _generated_key(text)
        lib_path = GEN_DIR / f"lib{key}.so"
        paths.append(lib_path)
        if lib_path.exists() or any(k == key for k, *_ in procs):
            continue
        nvcc = nvcc or _nvcc()
        src = GEN_DIR / f"{key}.cu"
        src.write_text(text)
        tmp = GEN_DIR / f"lib{key}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-shared",
               str(src), "-o", str(tmp)]
        procs.append((key, tmp, lib_path, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    errors = []
    for key, tmp, lib_path, t0, proc in procs:
        out, _ = proc.communicate()
        GENERATED_BUILD_S[key] = time.perf_counter() - t0
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{key}.cu (rc {proc.returncode}):\n{text}")
            continue
        if verbose and text.strip():
            print(f"[nvcc {key}.cu]\n{text}", flush=True)
        os.replace(tmp, lib_path)
    if errors:
        raise RuntimeError("nvcc failed on generated kernels:\n"
                           + "\n".join(errors))
    return paths


def load_generated(text: str, entries: list[str]):
    """The loaded library of a generated source (built on first use);
    each name in `entries` is bound as
    (lde, per, out, N, B, stream) -> int."""
    key = _generated_key(text)
    handle = _generated.get(key)
    if handle is not None:
        return handle
    with _lock:
        handle = _generated.get(key)
        if handle is None:
            path, = build_generated([text])
            handle = ctypes.CDLL(str(path))
            for name in entries:
                fn = getattr(handle, name)
                fn.argtypes = [_P, _P, _P, _L, _L, _P]
                fn.restype = ctypes.c_int
            _generated[key] = handle
    return handle


def call(entry: str, device: torch.device, *args) -> None:
    """Launch C entry `entry` on `device`'s current stream; raises if the
    launch reports an error."""
    fn = getattr(lib(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(fn(*args, stream), entry)


def check(code: int, entry: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed with error {code}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def require_int32_cuda(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
