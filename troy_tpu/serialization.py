"""Byte-stream serialization of ciphertexts, plaintexts, and keys.

Semantics-compatible with the reference's persistence layer
(reference: src/serialize.h:1-17 raw savet/loadt,
src/ciphertext_cuda.cu:16-140 save/load with seed compression and the
saveTerms/loadTerms partial-coefficient protocol used by the HE matmul
serializeOutputs path, app/LinearHelper.cuh:686-750).

Format: little-endian fixed headers + raw uint64 arrays. Seed-compressed
symmetric ciphertexts store c0 plus the 64-bit XOF seed; load regenerates
c1 (the reference's load refuses seeded streams — ciphertext_cuda.cu:104 —
we accept and expand them, strictly more capable). saveTerms writes only
the selected c0 coefficient positions (every limb) plus the full remaining
components, after leaving NTT form; loadTerms zero-fills and re-NTTs.
"""

from __future__ import annotations

import struct as _struct
from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext
from .he_types import Ciphertext, Plaintext, PublicKey, SecretKey, \
    KSwitchKeys, RelinKeys, GaloisKeys
from .ops import ntt as dntt

_MAGIC_CT = b"TCT1"
_MAGIC_PT = b"TPT1"
_MAGIC_KEY = b"TKY1"


def _u64s(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<u8").tobytes()


@jax.jit
def _batch_intt(data, cd_ntt):
    return dntt.rns_ntt_inverse(data, cd_ntt)


def fetch_ciphertexts_host(cts: Sequence[Ciphertext], context: HeContext,
                           to_coeff: bool = False) -> List[np.ndarray]:
    """ONE device->host transfer for a list of same-shape ciphertexts.

    Per-ciphertext ``np.asarray`` round trips would dominate protocol
    serialization; stacking into a single transfer
    (with the NTT inversion batched into one dispatch when ``to_coeff``)
    makes the whole output sweep one round trip."""
    if not cts:
        return []
    if len(cts) == 1:
        # no batching win for one ciphertext — and introducing a new
        # stacked executable costs a fresh compile in the degraded
        # post-readback phase, far more than the single transfer saves
        ct = cts[0]
        if to_coeff and ct.is_ntt_form:
            cd = context.get_context_data(ct.level)
            return [np.asarray(dntt.rns_ntt_inverse(ct.data, cd.ntt))]
        return [np.asarray(ct.data)]
    stacked = jnp.stack([c.data for c in cts])
    if to_coeff and cts[0].is_ntt_form:
        cd = context.get_context_data(cts[0].level)
        stacked = _batch_intt(stacked, cd.ntt)
    host = np.asarray(stacked)
    return [host[i] for i in range(len(cts))]


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------

def save_ciphertext(ct: Ciphertext,
                    host_data: Optional[np.ndarray] = None) -> bytes:
    """(ciphertext_cuda.cu:16-42). host_data: optional pre-fetched numpy
    copy of ct.data (see fetch_ciphertexts_host) to avoid a per-call
    device->host transfer."""
    if ct.seed != 0 and ct.size != 2:
        raise ValueError("seed-compressed ciphertext must have size 2")
    data = np.asarray(ct.data) if host_data is None else host_data
    size, limbs, n = data.shape
    head = _MAGIC_CT + _struct.pack(
        "<BBHIQQdQ", ct.level, int(ct.is_ntt_form), size, limbs, n,
        ct.seed, ct.scale, ct.correction_factor)
    if ct.seed != 0:
        return head + _u64s(data[0])
    return head + _u64s(data)


def load_ciphertext(raw: bytes, context: HeContext) -> Ciphertext:
    """(ciphertext_cuda.cu:85-106; seeded streams are expanded here)"""
    if raw[:4] != _MAGIC_CT:
        raise ValueError("not a ciphertext stream")
    level, is_ntt, size, limbs, n, seed, scale, correction = _struct.unpack(
        "<BBHIQQdQ", raw[4:4 + 40])
    off = 44
    if seed != 0:
        c0 = np.frombuffer(raw, dtype="<u8", count=limbs * n,
                           offset=off).reshape(limbs, n)
        data = np.zeros((2, limbs, n), dtype=np.uint64)
        data[0] = c0
        ct = Ciphertext(data=jnp.asarray(data), level=level,
                        is_ntt_form=bool(is_ntt), scale=scale,
                        correction_factor=correction, seed=seed)
        from . import rlwe
        return rlwe.expand_seed(ct, context.get_context_data(level))
    data = np.frombuffer(raw, dtype="<u8", count=size * limbs * n,
                         offset=off).reshape(size, limbs, n)
    return Ciphertext(data=jnp.asarray(data.copy()), level=level,
                      is_ntt_form=bool(is_ntt), scale=scale,
                      correction_factor=correction)


def save_terms(ct: Ciphertext, context: HeContext,
               term_ids: Sequence[int],
               host_coeff_data: Optional[np.ndarray] = None) -> bytes:
    """Partial save: selected c0 coefficients + full higher components
    (ciphertext_cuda.cu:44-83 saveTerms). host_coeff_data: optional
    pre-fetched COEFFICIENT-domain numpy copy (fetch_ciphertexts_host with
    to_coeff=True) to avoid a per-call iNTT dispatch + transfer."""
    if ct.seed != 0:
        raise ValueError("expand the seed before saving terms")
    cd = context.get_context_data(ct.level)
    if host_coeff_data is not None:
        data = host_coeff_data
    else:
        data = np.asarray(dntt.rns_ntt_inverse(ct.data, cd.ntt)
                          if ct.is_ntt_form else ct.data)
    size, limbs, n = data.shape
    head = _MAGIC_CT + _struct.pack(
        "<BBHIQQdQ", ct.level, int(ct.is_ntt_form), size, limbs, n,
        1 << 63, ct.scale, ct.correction_factor)   # high-bit marker: terms
    body = _u64s(data[0][:, np.asarray(term_ids, dtype=np.int64)])
    rest = _u64s(data[1:])
    return head + body + rest


def load_terms(raw: bytes, context: HeContext,
               term_ids: Sequence[int]) -> Ciphertext:
    """(ciphertext_cuda.cu:108-140 loadTerms)"""
    if raw[:4] != _MAGIC_CT:
        raise ValueError("not a ciphertext stream")
    level, is_ntt, size, limbs, n, marker, scale, correction = _struct.unpack(
        "<BBHIQQdQ", raw[4:4 + 40])
    if marker != 1 << 63:
        raise ValueError("stream was not saved with save_terms")
    off = 44
    ids = np.asarray(term_ids, dtype=np.int64)
    c0_sel = np.frombuffer(raw, dtype="<u8", count=limbs * len(ids),
                           offset=off).reshape(limbs, len(ids))
    off += 8 * limbs * len(ids)
    rest = np.frombuffer(raw, dtype="<u8", count=(size - 1) * limbs * n,
                         offset=off).reshape(size - 1, limbs, n)
    data = np.zeros((size, limbs, n), dtype=np.uint64)
    data[0][:, ids] = c0_sel
    data[1:] = rest
    arr = jnp.asarray(data)
    if is_ntt:
        cd = context.get_context_data(level)
        arr = dntt.rns_ntt_forward(arr, cd.ntt)
    return Ciphertext(data=arr, level=level, is_ntt_form=bool(is_ntt),
                      scale=scale, correction_factor=correction)


# ---------------------------------------------------------------------------
# plaintexts
# ---------------------------------------------------------------------------

def save_plaintext(pt: Plaintext) -> bytes:
    data = np.asarray(pt.data)
    level = 0xFF if pt.level is None else pt.level
    if data.ndim == 1:
        limbs, n = 0, data.shape[0]
    else:
        limbs, n = data.shape
    head = _MAGIC_PT + _struct.pack(
        "<BBIQd", level, int(pt.is_ntt_form), limbs, n, pt.scale)
    return head + _u64s(data)


def load_plaintext(raw: bytes) -> Plaintext:
    if raw[:4] != _MAGIC_PT:
        raise ValueError("not a plaintext stream")
    level, is_ntt, limbs, n, scale = _struct.unpack("<BBIQd", raw[4:4 + 22])
    off = 26
    count = (limbs if limbs else 1) * n
    data = np.frombuffer(raw, dtype="<u8", count=count, offset=off)
    data = data.reshape((limbs, n) if limbs else (n,))
    return Plaintext(data=jnp.asarray(data.copy()),
                     level=None if level == 0xFF else level,
                     is_ntt_form=bool(is_ntt), scale=scale)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def save_public_key(pk: PublicKey) -> bytes:
    data = np.asarray(pk.data)
    head = _MAGIC_KEY + b"P" + _struct.pack(
        "<IQQ", data.shape[1], data.shape[2], pk.seed)
    return head + _u64s(data)


def load_public_key(raw: bytes) -> PublicKey:
    if raw[:5] != _MAGIC_KEY + b"P":
        raise ValueError("not a public key stream")
    limbs, n, seed = _struct.unpack("<IQQ", raw[5:5 + 20])
    data = np.frombuffer(raw, dtype="<u8", count=2 * limbs * n,
                         offset=25).reshape(2, limbs, n)
    return PublicKey(data=jnp.asarray(data.copy()), seed=seed)


def save_secret_key(sk: SecretKey) -> bytes:
    data = np.asarray(sk.data)
    head = _MAGIC_KEY + b"S" + _struct.pack("<IQ", *data.shape)
    return head + _u64s(data)


def load_secret_key(raw: bytes) -> SecretKey:
    if raw[:5] != _MAGIC_KEY + b"S":
        raise ValueError("not a secret key stream")
    limbs, n = _struct.unpack("<IQ", raw[5:5 + 12])
    data = np.frombuffer(raw, dtype="<u8", count=limbs * n,
                         offset=17).reshape(limbs, n)
    return SecretKey(data=jnp.asarray(data.copy()))


def _save_kswitch(keys: KSwitchKeys, tag: bytes) -> bytes:
    idxs = sorted(keys.keys)
    out = [_MAGIC_KEY + tag + _struct.pack("<I", len(idxs))]
    for i in idxs:
        arr = np.asarray(keys.keys[i])
        out.append(_struct.pack("<QIIIQ", i, *arr.shape))
        out.append(_u64s(arr))
    return b"".join(out)


def _load_kswitch(raw: bytes, tag: bytes, cls):
    if raw[:5] != _MAGIC_KEY + tag:
        raise ValueError("wrong key stream tag")
    count, = _struct.unpack("<I", raw[5:9])
    off = 9
    keys = {}
    for _ in range(count):
        idx, d0, d1, d2, d3 = _struct.unpack("<QIIIQ", raw[off:off + 28])
        off += 28
        cnt = d0 * d1 * d2 * d3
        arr = np.frombuffer(raw, dtype="<u8", count=cnt,
                            offset=off).reshape(d0, d1, d2, d3)
        off += 8 * cnt
        keys[int(idx)] = jnp.asarray(arr.copy())
    return cls(keys=keys)


def save_relin_keys(k: RelinKeys) -> bytes:
    return _save_kswitch(k, b"R")


def load_relin_keys(raw: bytes) -> RelinKeys:
    return _load_kswitch(raw, b"R", RelinKeys)


def save_galois_keys(k: GaloisKeys) -> bytes:
    return _save_kswitch(k, b"G")


def load_galois_keys(raw: bytes) -> GaloisKeys:
    return _load_kswitch(raw, b"G", GaloisKeys)


def save_kswitch_keys(k: KSwitchKeys) -> bytes:
    return _save_kswitch(k, b"K")


def load_kswitch_keys(raw: bytes) -> KSwitchKeys:
    return _load_kswitch(raw, b"K", KSwitchKeys)


# ---------------------------------------------------------------------------
# encryption parameters
# ---------------------------------------------------------------------------

_MAGIC_PARMS = b"TEP1"


def save_parms(parms) -> bytes:
    """Serialize EncryptionParameters so the client/server protocol can
    agree on a parameter set over the wire. The reference inherited this
    from SEAL but stripped it (commented out, src/encryptionparams.h:
    345-395) — we keep it, as the two-party app protocol needs it."""
    head = _MAGIC_PARMS + _struct.pack(
        "<BQB", int(parms.scheme), parms.poly_modulus_degree,
        len(parms.coeff_modulus))
    body = _struct.pack(f"<{len(parms.coeff_modulus)}Q",
                        *[m.value for m in parms.coeff_modulus])
    return head + body + _struct.pack("<Q", parms.plain_modulus.value)


def load_parms(raw: bytes):
    from .params import EncryptionParameters, SchemeType
    from .modulus import Modulus
    if raw[:4] != _MAGIC_PARMS:
        raise ValueError("not an encryption-parameters stream")
    scheme, n, k = _struct.unpack("<BQB", raw[4:14])
    vals = _struct.unpack(f"<{k}Q", raw[14:14 + 8 * k])
    plain, = _struct.unpack("<Q", raw[14 + 8 * k:22 + 8 * k])
    return EncryptionParameters(
        scheme=SchemeType(scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(Modulus(v) for v in vals),
        plain_modulus=Modulus(plain))
