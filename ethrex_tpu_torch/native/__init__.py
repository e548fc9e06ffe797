"""Build and load the port's native host engines.

Four C/C++ sources live beside this file: `keccak.c` (Keccak-256),
`secp256k1.c` (ECDSA public-key recovery), `mpt.cpp` (the Merkle-Patricia
trie merkleizer) and `evm.cpp` (the EVM's frame-local opcode loop).  Each
engine is compiled at its first use, never at import, with the flags of
`ENGINES`, into `build/ethrex_tpu_torch/host/lib<name>.so` under the
checkout, and bound with `ctypes`.

A stamp beside each library holds a hash of its sources, its command and
the compiler's version: a library is rebuilt when any of them changes.  A
build writes to a temporary path of its own process and then renames it
into place, so concurrent processes (test workers) never load a
half-written file.  A failed build or load raises `BuildError` with the
compiler's output; nothing falls back to a Python path.  The Python forms
(`crypto.keccak._keccak256_py`, `crypto.secp256k1.recover`, `trie.Trie`,
`evm.vm.EVM._run_py`) are the oracles the tests hold the engines to; only
`ETHREX_TPU_NATIVE_EVM=0` and `ETHREX_TPU_NATIVE_MPT=0` select them on
the main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "ethrex_tpu_torch" / "host"

_C = ["gcc", "-O3", "-shared", "-fPIC"]
_CXX = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]

# name -> (compiler and flags, sources, sources compiled as C after
# "-x c": keccak.c keeps an unmangled keccak256 in a C++ library)
ENGINES = {
    "keccak": (_C, ["keccak.c"], []),
    "secp256k1": (_C, ["secp256k1.c"], []),
    "mpt": (_CXX, ["mpt.cpp"], ["keccak.c"]),
    "evm": (_CXX, ["evm.cpp"], ["keccak.c"]),
}

# name -> seconds of the compile this process ran (absent: none ran)
BUILD_S: dict = {}

_lock = threading.Lock()
_libs: dict = {}
_compiler_versions: dict = {}


class BuildError(RuntimeError):
    """A host engine failed to build or to load."""


def _compiler_version(compiler: str) -> str:
    version = _compiler_versions.get(compiler)
    if version is None:
        try:
            proc = subprocess.run([compiler, "--version"],
                                  capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"{compiler} not found: the host engines "
                             f"cannot be built ({e})") from e
        version = (proc.stdout.splitlines() or [""])[0]
        _compiler_versions[compiler] = version
    return version


def _command(name: str, src_dir: Path, out: Path) -> list:
    """The compiler's command line for engine `name`."""
    flags, sources, c_sources = ENGINES[name]
    cmd = [*flags, "-o", str(out), *(str(src_dir / s) for s in sources)]
    if c_sources:
        cmd += ["-x", "c", *(str(src_dir / s) for s in c_sources)]
    return cmd


def build(name: str, src_dir: Path | None = None,
          build_dir: Path | None = None) -> Path:
    """Compile engine `name` unless its stamp matches; returns the
    library's path.  Raises BuildError with the compiler's output."""
    src_dir = Path(src_dir or SRC_DIR)
    build_dir = Path(build_dir or BUILD_DIR)
    flags, sources, c_sources = ENGINES[name]
    lib = build_dir / f"lib{name}.so"
    stamp = build_dir / f"lib{name}.stamp"
    h = hashlib.sha256()
    h.update(repr(ENGINES[name]).encode())
    h.update(_compiler_version(flags[0]).encode())
    for s in sources + c_sources:
        h.update((src_dir / s).read_bytes())
    digest = h.hexdigest()
    if lib.exists() and stamp.exists() and \
            stamp.read_text().strip() == digest:
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{lib.name}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(_command(name, src_dir, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"building the {name} engine failed "
                         f"(exit {proc.returncode}):\n"
                         f"{(proc.stdout + proc.stderr)[-2000:]}")
    os.replace(tmp, lib)
    tmp_stamp = build_dir / f"{stamp.name}.tmp{os.getpid()}"
    tmp_stamp.write_text(digest)
    os.replace(tmp_stamp, stamp)
    BUILD_S[name] = time.perf_counter() - t0
    return lib


def load(name: str, bind) -> ctypes.CDLL:
    """The engine's library, built if needed, loaded once per process and
    passed to `bind(lib)` (which sets its argtypes) before first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
                bind(lib)
            except (OSError, AttributeError) as e:
                raise BuildError(f"loading the {name} engine from {path} "
                                 f"failed: {e}") from e
            _libs[name] = lib
    return lib


def loaded() -> list:
    """Names of the engines this process has loaded."""
    return sorted(_libs)
