"""ctypes bindings for the native host runtime (troy_native.cpp).

Compiled on first use with g++ from the committed source into a
content-hash-keyed shared object under the checkout's ``build/`` (no
pip/cmake needed). Every entry point has a pure-Python fallback, so the
framework works without a toolchain, only slower on the host paths; the
first use says on stderr which of the two is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "troy_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "troy_native")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"troy_native_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".build{os.getpid()}"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.xof_fill.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                             ctypes.c_void_p, ctypes.c_uint64]
    lib.crt_compose_centered_double.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_double, ctypes.c_void_p]
    lib.ntt_tables_fill.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64] + [ctypes.c_void_p] * 4
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _build()
            print(f"troy_tpu.native: host library {_lib._name}",
                  file=sys.stderr)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            print(f"troy_tpu.native: build failed ({e}; "
                  f"{detail.decode(errors='replace').strip()[:500]}); "
                  "using the pure-Python host paths", file=sys.stderr)
    return _lib


def available() -> bool:
    return get_lib() is not None


def xof_fill(seed: bytes, counter0: int, nbytes: int) -> Optional[bytes]:
    """nbytes of the buffered XOF stream starting at block counter0."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(nbytes, dtype=np.uint8)
    lib.xof_fill(seed, counter0, out.ctypes.data, nbytes)
    return out.tobytes()


def ntt_tables_fill(n: int, q: int, root: int, inv_root: int):
    """Bit-reversed root-power tables + Shoup quotients; None if no lib.
    Returns (powers, powers_shoup, inv_powers, inv_powers_shoup) u64[n]."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.empty(n, dtype=np.uint64) for _ in range(4)]
    lib.ntt_tables_fill(n, q, root, inv_root,
                        *(a.ctypes.data for a in arrs))
    return tuple(arrs)


def crt_compose_centered_double(residues: np.ndarray, moduli, inv_punctured,
                                inv_punctured_shoup, punctured_words,
                                q_words, inv_scale: float
                                ) -> Optional[np.ndarray]:
    """(k, n) residues -> (n,) centered doubles scaled by inv_scale."""
    lib = get_lib()
    if lib is None:
        return None
    residues = np.ascontiguousarray(residues, dtype=np.uint64)
    k, n = residues.shape
    moduli = np.ascontiguousarray(moduli, dtype=np.uint64)
    invp = np.ascontiguousarray(inv_punctured, dtype=np.uint64)
    invps = np.ascontiguousarray(inv_punctured_shoup, dtype=np.uint64)
    pw = np.ascontiguousarray(punctured_words, dtype=np.uint64)   # (k, w)
    qw = np.ascontiguousarray(q_words, dtype=np.uint64)           # (w,)
    w = qw.shape[0]
    out = np.empty(n, dtype=np.float64)
    lib.crt_compose_centered_double(
        residues.ctypes.data, k, n, moduli.ctypes.data, invp.ctypes.data,
        invps.ctypes.data, pw.ctypes.data, qw.ctypes.data, w,
        ctypes.c_double(inv_scale), out.ctypes.data)
    return out
