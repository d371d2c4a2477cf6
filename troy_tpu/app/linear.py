"""HE linear algebra: Cheetah-style coefficient-packed matmul and conv2d.

Semantics-compatible with the reference's application layer
(reference: app/LinearHelper.cuh — Plain2d/Cipher2d :21-206, MatmulHelper
:228-750 with the tiling search :242-307, reversed-coefficient weight
encoding :309-326, LWE-trace output packing :592-650, saveTerms output
serialization :686-750; Conv2dHelper :753-1195 with the 5-dim block search
and im2col-free negacyclic convolution packing).

Scheme-agnostic: the helpers consume polynomial-coefficient encoders —
BatchEncoder.encode_polynomial for BFV/BGV (exact integers mod t) or
CKKSEncoder.encode_polynomial for approximate arithmetic — mirroring the
reference's BFV/CKKS twin helpers (LinearHelperCKKS.cuh).
"""

from __future__ import annotations

import struct as _struct
from typing import Callable, List, Optional, Sequence

import numpy as np

from functools import partial

import jax
import jax.numpy as jnp

from ..context import HeContext, ContextData
from ..he_types import Ciphertext, Plaintext, GaloisKeys, RelinKeys
from ..encryptor import Encryptor
from ..decryptor import Decryptor
from ..evaluator import (Evaluator, _MAX_GALOIS_FOLDS_PER_DISPATCH,
                         _bfv_multiply, _field_trace_batch_core,
                         _ntt_form_multiply, _plain_to_ntt)
from ..encoder import BatchEncoder
from ..ops import ntt as dntt
from ..ops import poly as dpoly
from ..params import SchemeType
from .. import serialization as ser


@partial(jax.jit, static_argnames=("ct_coeff", "pt_mod_t"))
def _matmul_tiles_core(ct_tiles: jnp.ndarray, pt_tiles: jnp.ndarray,
                       cd: ContextData, ct_coeff: bool,
                       pt_mod_t: bool) -> jnp.ndarray:
    """The whole tile fan-out of the coefficient-packed matmul/conv as ONE
    executable: out[x, y] = sum_i ct[x, i] (*) pt[i, y], where (*) is the
    multiply_plain dyadic product in the NTT domain (the reference loops
    multiplyPlain+add per tile: LinearHelper.cuh:403-427).

    ct_tiles (X, I, 2, k, n); pt_tiles (I, Y, n) mod-t when pt_mod_t else
    (I, Y, k, n) NTT mod-q. ct_coeff: cts arrive (and leave) in
    coefficient form (BFV); otherwise they are NTT-form (CKKS/BGV)."""
    ct_ntt = dntt.rns_ntt_forward(ct_tiles, cd.ntt) if ct_coeff else ct_tiles
    w_ntt = _plain_to_ntt.__wrapped__(pt_tiles, cd) if pt_mod_t else pt_tiles
    acc = None
    for i in range(ct_tiles.shape[1]):
        a_i = ct_ntt[:, i][:, None]          # (X, 1, 2, k, n)
        w_i = w_ntt[i][:, None]              # (Y, 1, k, n) -> bcast (X,Y,2,..)
        prod = dntt.rns_dyadic_mul(a_i, w_i, cd.ntt)
        acc = prod if acc is None else dpoly.rns_add(acc, prod, cd.ntt)
    return dntt.rns_ntt_inverse(acc, cd.ntt) if ct_coeff else acc


# Dispatch-size guards, not measured on the GPU yet (their values come
# from an earlier target with a smaller device memory): one program per
# contraction step bounds the unrolled BEHZ pipeline of the ct x ct
# contraction, while the vmap inside each step still shares the lifts and
# batches the products; chunking the output-tile axis of the ct x pt
# contraction bounds its live set (the reference conv2d config, 1x64x256
# 56x56 k3 -> X=1, I=64, Y=52 tiles at n=16384), while the NTTs of the
# ciphertext tiles are still computed exactly once.
_MAX_CIPHER_MULS_PER_DISPATCH = 32
_MAX_PLAIN_MULS_PER_DISPATCH = 2048


@partial(jax.jit, static_argnames=())
def _tiles_forward_ntt(ct_tiles: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dntt.rns_ntt_forward(ct_tiles, cd.ntt)


@partial(jax.jit, static_argnames=())
def _tiles_inverse_ntt(acc: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dntt.rns_ntt_inverse(acc, cd.ntt)


@partial(jax.jit, static_argnames=())
def _tiles_plain_ntt(pt_tiles: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return _plain_to_ntt.__wrapped__(pt_tiles, cd)


def _matmul_tiles_chunked(ct_tiles: jnp.ndarray, pt_tiles: jnp.ndarray,
                          cd: ContextData, ct_coeff: bool,
                          pt_mod_t: bool) -> jnp.ndarray:
    """ct x pt tile contraction with the output-tile axis chunked to bound
    each executable's live set (big conv2d shapes)."""
    X, I = ct_tiles.shape[0], ct_tiles.shape[1]
    Y = pt_tiles.shape[1]
    if X * I * Y <= _MAX_PLAIN_MULS_PER_DISPATCH:
        return _matmul_tiles_core(ct_tiles, pt_tiles, cd, ct_coeff,
                                  pt_mod_t)
    ct_ntt = _tiles_forward_ntt(ct_tiles, cd) if ct_coeff else ct_tiles
    y_chunk = max(1, _MAX_PLAIN_MULS_PER_DISPATCH // max(1, X * I))
    parts = []
    for y0 in range(0, Y, y_chunk):
        pt_c = pt_tiles[:, y0:y0 + y_chunk]
        pt_c = _tiles_plain_ntt(pt_c, cd) if pt_mod_t else pt_c
        parts.append(_matmul_tiles_core(ct_ntt, pt_c, cd, False, False))
    acc = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    return _tiles_inverse_ntt(acc, cd) if ct_coeff else acc


@jax.jit
def _matmul_cipher_pairs_core(a_col: jnp.ndarray, w_row: jnp.ndarray,
                              cd: ContextData) -> jnp.ndarray:
    """One contraction step: a_col (X, 2, k, n) x w_row (Yc, 2, k, n) ->
    (X, Yc, 3, k, n). The nested vmap broadcasts share each tile's
    expensive BEHZ lift across the whole row/column while the per-product
    t/Q floor keeps the reference's rounding order
    (evaluator_cuda.cu:283-382 per product, then addInplace)."""
    if cd.scheme == SchemeType.bfv:
        mul = lambda da, dw: _bfv_multiply.__wrapped__(da, dw, cd)
    else:
        mul = lambda da, dw: _ntt_form_multiply.__wrapped__(da, dw, cd)
    return jax.vmap(jax.vmap(mul, in_axes=(None, 0)),
                    in_axes=(0, None))(a_col, w_row)


@jax.jit
def _acc_add(a: jnp.ndarray, b: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dpoly.rns_add(a, b, cd.ntt)


def _matmul_cipher_tiles_core(a_tiles: jnp.ndarray, w_tiles: jnp.ndarray,
                              cd: ContextData) -> jnp.ndarray:
    """ct x ct tile contraction out[x, y] = sum_i mult(a[x, i], w[i, y]),
    chunked into per-step dispatches (see _MAX_CIPHER_MULS_PER_DISPATCH)."""
    X, I = a_tiles.shape[0], a_tiles.shape[1]
    Y = w_tiles.shape[1]
    y_chunk = max(1, _MAX_CIPHER_MULS_PER_DISPATCH // max(1, X))
    acc = None
    for i in range(I):
        parts = []
        for y0 in range(0, Y, y_chunk):
            parts.append(_matmul_cipher_pairs_core(
                a_tiles[:, i], w_tiles[i, y0:y0 + y_chunk], cd))
        prod = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        acc = prod if acc is None else _acc_add(acc, prod, cd)
    return acc


def _run_cipher_contraction(ev: Evaluator, a2d: "Cipher2d", w2d: "Cipher2d",
                            transpose_w: bool) -> "Cipher2d":
    """Stack two Cipher2d tile grids and contract ct x ct on device."""
    template = a2d.data[0][0]
    w0 = w2d.data[0][0]
    if w0.level != template.level:
        raise ValueError("ciphertext level mismatch")
    cd = ev.context.get_context_data(template.level)
    a_tiles = jnp.stack([jnp.stack([ct.data for ct in row])
                         for row in a2d.data])
    w_tiles = jnp.stack([jnp.stack([ct.data for ct in row])
                         for row in w2d.data])
    if transpose_w:
        w_tiles = jnp.swapaxes(w_tiles, 0, 1)
    out = _matmul_cipher_tiles_core(a_tiles, w_tiles, cd)
    scale = template.scale * w0.scale \
        if cd.scheme == SchemeType.ckks else template.scale
    corr = template.correction_factor * w0.correction_factor \
        % int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    return Cipher2d([[template.replace(data=out[x, y], scale=scale,
                                       correction_factor=corr, seed=0)
                      for y in range(out.shape[1])]
                     for x in range(out.shape[0])])


def _run_tile_contraction(ev: Evaluator, ct2d: "Cipher2d", pt2d: "Plain2d",
                          transpose_ct: bool, transpose_pt: bool,
                          transpose_out: bool,
                          ct_sharding=None) -> "Cipher2d":
    """Stack a Cipher2d x Plain2d tile grid, contract on device, unpack.
    ct_sharding optionally places the stacked ciphertext tiles (e.g. a
    NamedSharding over the batch-block axis) before the contraction, so a
    device mesh partitions the fan-out (parallel.sharding wraps this)."""
    template = ct2d.data[0][0]
    cd = ev.context.get_context_data(template.level)
    ct_tiles = jnp.stack([jnp.stack([ct.data for ct in row])
                          for row in ct2d.data])
    if transpose_ct:
        ct_tiles = jnp.swapaxes(ct_tiles, 0, 1)
    if ct_sharding is not None:
        ct_tiles = jax.device_put(ct_tiles, ct_sharding)
    pt_tiles = jnp.stack([jnp.stack([p.data for p in row])
                          for row in pt2d.data])
    if transpose_pt:
        pt_tiles = jnp.swapaxes(pt_tiles, 0, 1)
    pt0 = pt2d.data[0][0]
    if pt0.is_ntt_form and pt0.level != template.level:
        raise ValueError("NTT-form plaintext level mismatch")
    out = _matmul_tiles_chunked(ct_tiles, pt_tiles, cd,
                                not template.is_ntt_form,
                                not pt0.is_ntt_form)
    if transpose_out:
        out = jnp.swapaxes(out, 0, 1)
    scale = template.scale * pt0.scale if pt0.is_ntt_form else template.scale
    return Cipher2d([[template.replace(data=out[x, y], scale=scale, seed=0)
                      for y in range(out.shape[1])]
                     for x in range(out.shape[0])])


@partial(jax.jit, static_argnames=("pre_shift",))
def _pack_preshift_core(data: jnp.ndarray, cd: ContextData,
                        pre_shift: int) -> jnp.ndarray:
    return dpoly.negacyclic_shift(data, pre_shift, cd.ntt)


@partial(jax.jit, static_argnames=("pack_slots",))
def _pack_group_fold_core(data: jnp.ndarray, cd: ContextData,
                          pack_slots: int) -> jnp.ndarray:
    """Fold each group of pack_slots traced ciphertexts into one with
    per-slot monomial shifts (the tail of LinearHelper.cuh:592-650)."""
    m = data.shape[0]
    groups = ceil_div(m, pack_slots)
    pad = groups * pack_slots - m
    if pad:
        data = jnp.concatenate(
            [data, jnp.zeros((pad,) + data.shape[1:], dtype=data.dtype)])
    grouped = data.reshape((groups, pack_slots) + data.shape[1:])
    acc = grouped[:, 0]
    for s in range(1, pack_slots):
        acc = dpoly.rns_add(
            acc, dpoly.negacyclic_shift(grouped[:, s], s, cd.ntt), cd.ntt)
    return acc


def _pack_outputs_core(data: jnp.ndarray, srcs, keeps, keys,
                       cd: ContextData, key_cd: ContextData,
                       pre_shift: int, mul: int, pack_slots: int,
                       ntt_domain: bool) -> jnp.ndarray:
    """The packOutputs pipeline (LinearHelper.cuh:592-650) over ALL
    output ciphertexts: pre-shift, divide by n/pack_slots, field trace
    (batched key-switches), then fold each group of pack_slots traces
    into one ciphertext. data (m, 2, k, n) ->
    (ceil(m/pack_slots), 2, k, n). The trace runs in bounded-length
    dispatches: XLA's compile time grows superlinearly in the chained
    key-switch count per program (evaluator._MAX_GALOIS_FOLDS_PER_
    DISPATCH; a full n=16384 trace chains 10)."""
    if pre_shift:
        data = _pack_preshift_core(data, cd, pre_shift)
    step = max(1, _MAX_GALOIS_FOLDS_PER_DISPATCH)
    first = True
    for i in range(0, len(srcs), step):
        data = _field_trace_batch_core(
            data, srcs[i:i + step], keeps[i:i + step], keys[i:i + step],
            cd, key_cd, mul if first else 0, ntt_domain)
        first = False
    if first and mul:
        # no trace steps: apply the divide scaling alone
        data = _field_trace_batch_core(data, (), (), (), cd, key_cd,
                                       mul, ntt_domain)
    return _pack_group_fold_core(data, cd, pack_slots)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Plain2d:
    """(LinearHelper.cuh:21)"""

    def __init__(self, data: Optional[List[List[Plaintext]]] = None):
        self.data: List[List[Plaintext]] = data if data is not None else []

    def __getitem__(self, i):
        return self.data[i]

    def encrypt(self, encryptor: Encryptor) -> "Cipher2d":
        return Cipher2d([[encryptor.encrypt(p) for p in row]
                         for row in self.data])

    def encrypt_symmetric(self, encryptor: Encryptor,
                          save_seed: bool = False) -> "Cipher2d":
        # batched: one upload + one executable for all tiles
        flat = [p for row in self.data for p in row]
        cts = encryptor.encrypt_symmetric_many(flat, save_seed)
        out, i = [], 0
        for row in self.data:
            out.append(cts[i:i + len(row)])
            i += len(row)
        return Cipher2d(out)


class Cipher2d:
    """(LinearHelper.cuh:42)"""

    def __init__(self, data: Optional[List[List[Ciphertext]]] = None):
        self.data: List[List[Ciphertext]] = data if data is not None else []

    def __getitem__(self, i):
        return self.data[i]

    def save(self, context: Optional[HeContext] = None) -> bytes:
        rows = len(self.data)
        cols = len(self.data[0]) if rows else 0
        out = [_struct.pack("<QQ", rows, cols)]
        flat = [ct for row in self.data for ct in row]
        # one batched device->host transfer for all tiles (seed-compressed
        # tiles store c0 only, which the stacked fetch still covers)
        hosts = ser.fetch_ciphertexts_host(flat, context) \
            if all(c.data.shape == flat[0].data.shape for c in flat) \
            else [None] * len(flat)
        idx = 0
        for row in self.data:
            if len(row) != cols:
                raise ValueError("not rectangular")
            for ct in row:
                blob = ser.save_ciphertext(ct, host_data=hosts[idx])
                idx += 1
                out.append(_struct.pack("<Q", len(blob)))
                out.append(blob)
        return b"".join(out)

    @classmethod
    def load(cls, raw: bytes, context: HeContext) -> "Cipher2d":
        rows, cols = _struct.unpack("<QQ", raw[:16])
        off = 16
        data = []
        for _ in range(rows):
            row = []
            for _ in range(cols):
                ln, = _struct.unpack("<Q", raw[off:off + 8])
                off += 8
                row.append(ser.load_ciphertext(raw[off:off + ln], context))
                off += ln
            data.append(row)
        return cls(data)

    def mod_switch_to_next(self, ev: Evaluator) -> "Cipher2d":
        return Cipher2d([[ev.mod_switch_to_next(c) for c in row]
                         for row in self.data])

    def relinearize(self, ev: Evaluator, rlk: RelinKeys) -> "Cipher2d":
        return Cipher2d([[ev.relinearize(c, rlk) for c in row]
                         for row in self.data])

    def add(self, ev: Evaluator, other: "Cipher2d") -> "Cipher2d":
        return Cipher2d([[ev.add(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def add_plain(self, ev: Evaluator, other: Plain2d) -> "Cipher2d":
        return Cipher2d([[ev.add_plain(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def switch_key(self, ev: Evaluator, ksk) -> "Cipher2d":
        """Re-key every ciphertext (LinearHelper.cuh:124 switch_key)."""
        return Cipher2d([[ev.apply_keyswitching(c, ksk) for c in row]
                         for row in self.data])

    def multiply_scalar(self, ev: Evaluator,
                        encode_poly: Callable[[np.ndarray], Plaintext],
                        scalar: int) -> "Cipher2d":
        """Multiply every ciphertext by the constant polynomial [scalar]
        (LinearHelper.cuh:134 multiplyScalarInplace)."""
        p = encode_poly(np.array([scalar], dtype=np.uint64))
        return Cipher2d([[ev.multiply_plain(c, p) for c in row]
                         for row in self.data])


class MatmulHelper:
    """Coefficient-packed batched matmul (LinearHelper.cuh:228).

    objective 0: encrypt inputs; 1: encrypt weights; 2: weight gradient.
    pack_lwe enables the field-trace output packing (packOutputs).
    """

    def __init__(self, batch_size: int, input_dims: int, output_dims: int,
                 slot_count: int, objective: int = 0, pack_lwe: bool = True):
        self.batch_size = batch_size
        self.input_dims = input_dims
        self.output_dims = output_dims
        self.slot_count = slot_count
        self.objective = objective
        self.pack_lwe = pack_lwe
        self._determine_block()

    # ---- tiling search (LinearHelper.cuh:242-307) ----
    def _determine_block(self):
        bs, ind, outd, slots = (self.batch_size, self.input_dims,
                                self.output_dims, self.slot_count)
        best = (0, 0, 0)
        c_best = 2 ** 31 - 1
        if not self.pack_lwe:
            for b in range(bs, 0, -1):
                bc = ceil_div(bs, b)
                if b >= slots:
                    continue
                if bc * 2 > c_best:
                    continue
                for i in range(1, slots // b):
                    o = min(slots // b // i, outd)
                    if i > ind or o < 1:
                        continue
                    if self.objective == 0:
                        c = bc * (ceil_div(ind, i) + ceil_div(outd, o))
                    elif self.objective == 1:
                        c = (bc + ceil_div(ind, i)) * ceil_div(outd, o)
                    elif self.objective == 2:
                        c = bc * ind + (bc + ceil_div(ind, i)) * ceil_div(outd, o)
                    else:
                        raise ValueError("invalid objective")
                    if c < c_best:
                        best, c_best = (b, i, o), c
        else:
            # the reference uses pow(slotCount, 0.33), not an exact cube
            # root (LinearHelper.cuh:271) — mirror it so block choices and
            # therefore ciphertext counts match exactly
            cube = slots ** 0.33
            i = 1
            while i * 2 < cube:
                i *= 2
            if i > ind:
                i = 1
                while i < ind:
                    i *= 2
            for b in range(1, bs + 1):
                bc = ceil_div(bs, b)
                if b > slots:
                    continue
                o = min(slots // b // i, outd)
                if o < 1:
                    continue
                if self.objective == 0:
                    c = bc * ceil_div(ind, i) + ceil_div(bc * ceil_div(outd, o), i)
                elif self.objective == 1:
                    c = (ceil_div(outd, o) * ceil_div(ind, i)
                         + ceil_div(bc * ceil_div(outd, o), i))
                elif self.objective == 2:
                    c = (bc * ceil_div(ind, i)
                         + ceil_div(outd, o) * ceil_div(ind, i)
                         + ceil_div(bc * ceil_div(outd, o), i))
                else:
                    raise ValueError("invalid objective")
                if c < c_best:
                    best, c_best = (b, i, o), c
        self.batch_block, self.input_block, self.output_block = best
        if self.batch_block == 0:
            raise ValueError("no feasible tiling for these dimensions")

    # ---- encoders (LinearHelper.cuh:309-401) ----
    def encode_weights(self, encode_poly: Callable[[np.ndarray], Plaintext],
                       weights: np.ndarray) -> Plain2d:
        """weights: (input_dims, output_dims). Blocks hold reversed input
        coefficients so the polynomial product aligns dot products."""
        h, w = self.input_block, self.output_block
        weights = np.asarray(weights)
        rows = []
        for li in range(0, self.input_dims, h):
            ui = min(li + h, self.input_dims)
            row = []
            for lj in range(0, self.output_dims, w):
                uj = min(lj + w, self.output_dims)
                vec = np.zeros(h * w, dtype=weights.dtype)
                blk = weights[li:ui, lj:uj]                    # (bi, bj)
                # vec[(j-lj)*h + h-1-(i-li)] = W[i, j]
                sub = np.zeros((uj - lj, h), dtype=weights.dtype)
                sub[:, h - blk.shape[0]:] = blk[::-1, :].T
                vec[:(uj - lj) * h] = sub.reshape(-1)
                row.append(encode_poly(vec))
            rows.append(row)
        return Plain2d(rows)

    def encode_inputs(self, encode_poly: Callable[[np.ndarray], Plaintext],
                      inputs: np.ndarray) -> Plain2d:
        """inputs: (batch_size, input_dims)."""
        iB, oB = self.input_block, self.output_block
        inputs = np.asarray(inputs)
        rows = []
        for li in range(0, self.batch_size, self.batch_block):
            ui = min(li + self.batch_block, self.batch_size)
            row = []
            for lj in range(0, self.input_dims, iB):
                uj = min(lj + iB, self.input_dims)
                vec = np.zeros(self.slot_count, dtype=inputs.dtype)
                for bi in range(li, ui):
                    vec[(bi - li) * iB * oB:(bi - li) * iB * oB + (uj - lj)] \
                        = inputs[bi, lj:uj]
                row.append(encode_poly(vec))
            rows.append(row)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor,
                       encode_poly, inputs) -> Cipher2d:
        # symmetric, as the reference's Plain2d::encrypt does
        # (LinearHelper.cuh:208-215 encryptSymmetric)
        return self.encode_inputs(encode_poly,
                                  inputs).encrypt_symmetric(encryptor)

    # ---- the matmul itself (LinearHelper.cuh:403-479) ----
    def matmul(self, ev: Evaluator, a: Cipher2d, w: Plain2d) -> Cipher2d:
        """out[b, j] = sum_i a[b, i] (*) w[i, j], all tiles in one fused
        contraction (LinearHelper.cuh:403-427)."""
        return _run_tile_contraction(ev, a, w, transpose_ct=False,
                                     transpose_pt=False, transpose_out=False)

    def matmul_cipher(self, ev: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        """ct x ct matmul (LinearHelper.cuh:429): one fused contraction,
        outputs size-3 (relinearize afterwards if needed)."""
        return _run_cipher_contraction(ev, a, w, transpose_w=False)

    def matmul_reverse(self, ev: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        """Encrypted weights, plain inputs: out[b, j] = sum_i w[i, j] (*)
        a[b, i] — the same contraction with the ciphertext grid transposed
        to (j, i) and the output transposed back."""
        return _run_tile_contraction(ev, w, a, transpose_ct=True,
                                     transpose_pt=True, transpose_out=True)

    # ---- output positions ----
    def _output_positions(self):
        """Positions of useful output coefficients within a block product."""
        iB, oB = self.input_block, self.output_block
        return lambda bi, oj: bi * iB * oB + oj * iB + iB - 1

    def decrypt_outputs(self, decode_poly: Callable[[Plaintext], np.ndarray],
                        decryptor: Decryptor, outputs: Cipher2d) -> np.ndarray:
        """(LinearHelper.cuh:540-591 decryptOutputs)"""
        iB, oB = self.input_block, self.output_block
        pos = self._output_positions()
        dec = np.zeros((self.batch_size, self.output_dims), dtype=np.object_)
        if not self.pack_lwe:
            flat = [ct for row in outputs.data for ct in row]
            plains = decryptor.decrypt_many(flat)   # one dispatch+transfer
            bufs = [decode_poly(p) for p in plains]
            cols = len(outputs.data[0])
            di = 0
            for li in range(0, self.batch_size, self.batch_block):
                ui = min(li + self.batch_block, self.batch_size)
                dj = 0
                for lj in range(0, self.output_dims, oB):
                    uj = min(lj + oB, self.output_dims)
                    buf = bufs[di * cols + dj]
                    for i in range(li, ui):
                        for j in range(lj, uj):
                            dec[i, j] = buf[pos(i - li, j - lj)]
                    dj += 1
                di += 1
        else:
            bufs = [decode_poly(p)
                    for p in decryptor.decrypt_many(outputs[0])]
            ob_count = ceil_div(self.output_dims, oB)
            di = 0
            for li in range(0, self.batch_size, self.batch_block):
                ui = min(li + self.batch_block, self.batch_size)
                dj = 0
                for lj in range(0, self.output_dims, oB):
                    uj = min(lj + oB, self.output_dims)
                    cipher_id = di * ob_count + dj
                    packed_id, packed_off = divmod(cipher_id, iB)
                    for i in range(li, ui):
                        for j in range(lj, uj):
                            dec[i, j] = bufs[packed_id][
                                (i - li) * iB * oB + (j - lj) * iB + packed_off]
                    dj += 1
                di += 1
        return dec

    def encode_outputs(self, encode_poly: Callable[[np.ndarray], Plaintext],
                       outputs: np.ndarray) -> Plain2d:
        """Encode an output matrix into the exact packed layout the matmul
        produces — the server uses it to add/subtract masks on the result
        (LinearHelper.cuh:481-560 encodeOutputs). outputs:
        (batch_size, output_dims)."""
        outputs = np.asarray(outputs)
        iB, oB = self.input_block, self.output_block
        if not self.pack_lwe:
            rows = []
            for li in range(0, self.batch_size, self.batch_block):
                ui = min(li + self.batch_block, self.batch_size)
                row = []
                for lj in range(0, self.output_dims, oB):
                    uj = min(lj + oB, self.output_dims)
                    vec = np.zeros(self.slot_count, dtype=outputs.dtype)
                    for i in range(li, ui):
                        for j in range(lj, uj):
                            vec[(i - li) * iB * oB + (j - lj) * iB
                                + iB - 1] = outputs[i, j]
                    row.append(encode_poly(vec))
                rows.append(row)
            return Plain2d(rows)
        ob_count = ceil_div(self.output_dims, oB)
        bb_count = ceil_div(self.batch_size, self.batch_block)
        bufs = [np.zeros(self.slot_count, dtype=outputs.dtype)
                for _ in range(ceil_div(bb_count * ob_count, iB))]
        di = 0
        for li in range(0, self.batch_size, self.batch_block):
            ui = min(li + self.batch_block, self.batch_size)
            dj = 0
            for lj in range(0, self.output_dims, oB):
                uj = min(lj + oB, self.output_dims)
                cipher_id = di * ob_count + dj
                packed_id, packed_off = divmod(cipher_id, iB)
                for i in range(li, ui):
                    for j in range(lj, uj):
                        bufs[packed_id][(i - li) * iB * oB + (j - lj) * iB
                                        + packed_off] = outputs[i, j]
                dj += 1
            di += 1
        return Plain2d([[encode_poly(b) for b in bufs]])

    # ---- encoded-weight serialization (LinearHelper.cuh:652-684) ----
    def serialize_encoded_weights(self, w: Plain2d) -> bytes:
        rows = len(w.data)
        cols = len(w.data[0]) if rows else 0
        if rows == 0 or cols == 0:
            raise ValueError("empty weight matrix")
        out = [_struct.pack("<QQ", rows, cols)]
        for row in w.data:
            if len(row) != cols:
                raise ValueError("weight matrix is not rectangular")
            for pt in row:
                blob = ser.save_plaintext(pt)
                out.append(_struct.pack("<Q", len(blob)))
                out.append(blob)
        return b"".join(out)

    @staticmethod
    def deserialize_encoded_weights(raw: bytes) -> Plain2d:
        rows, cols = _struct.unpack("<QQ", raw[:16])
        off = 16
        data = []
        for _ in range(rows):
            row = []
            for _ in range(cols):
                ln, = _struct.unpack("<Q", raw[off:off + 8])
                off += 8
                row.append(ser.load_plaintext(raw[off:off + ln]))
                off += ln
            data.append(row)
        return Plain2d(data)

    # ---- LWE-trace packing (LinearHelper.cuh:592-650 packOutputs) ----
    def pack_outputs(self, ev: Evaluator, auto_keys: GaloisKeys,
                     cipher: Cipher2d) -> Cipher2d:
        if not self.pack_lwe:
            raise ValueError("pack_lwe not enabled")
        if not cipher.data or not cipher.data[0]:
            return Cipher2d([[]])
        pack_slots = self.input_block
        n = self.slot_count
        field_trace_logn = 0
        ftn = 1
        while ftn != n // pack_slots:
            field_trace_logn += 1
            ftn *= 2

        flat = [ct for row in cipher.data for ct in row]
        ntt_domain = flat[0].is_ntt_form
        if ntt_domain and pack_slots > 1:
            raise ValueError("negacyclic shift expects coefficient form")
        srcs, keeps, keys = ev._field_trace_steps(auto_keys,
                                                  field_trace_logn,
                                                  ntt_domain)
        cd = ev.context.get_context_data(flat[0].level)
        stacked = jnp.stack([ct.data for ct in flat])
        pre_shift = (2 * n - (pack_slots - 1)) if pack_slots > 1 else 0
        packed = _pack_outputs_core(stacked, srcs, keeps, keys, cd,
                                    ev.context.key_context_data,
                                    pre_shift, n // pack_slots, pack_slots,
                                    ntt_domain)
        template = flat[0]
        output = [template.replace(data=packed[g], seed=0)
                  for g in range(packed.shape[0])]
        return Cipher2d([output])

    # ---- serialization (LinearHelper.cuh:686-750) ----
    def serialize_outputs(self, ev: Evaluator, context: HeContext,
                          x: Cipher2d) -> bytes:
        out = []
        if not self.pack_lwe:
            pos = self._output_positions()
            flat = [ct for row in x.data for ct in row]
            hosts = ser.fetch_ciphertexts_host(flat, context, to_coeff=True)
            di = 0
            idx = 0
            for li in range(0, self.batch_size, self.batch_block):
                ui = min(li + self.batch_block, self.batch_size)
                dj = 0
                for lj in range(0, self.output_dims, self.output_block):
                    uj = min(lj + self.output_block, self.output_dims)
                    required = [pos(i - li, j - lj)
                                for i in range(li, ui) for j in range(lj, uj)]
                    blob = ser.save_terms(x[di][dj], context, required,
                                          host_coeff_data=hosts[idx])
                    idx += 1
                    out.append(_struct.pack("<Q", len(blob)))
                    out.append(blob)
                    dj += 1
                di += 1
        else:
            count = ceil_div(ceil_div(self.batch_size, self.batch_block)
                             * ceil_div(self.output_dims, self.output_block),
                             self.input_block)
            if count != len(x.data[0]):
                raise ValueError("output ciphertext count incorrect")
            hosts = ser.fetch_ciphertexts_host(x[0], context)
            for ct, h in zip(x[0], hosts):
                blob = ser.save_ciphertext(ct, host_data=h)
                out.append(_struct.pack("<Q", len(blob)))
                out.append(blob)
        return b"".join(out)

    def deserialize_outputs(self, ev: Evaluator, context: HeContext,
                            raw: bytes) -> Cipher2d:
        off = 0

        def next_blob():
            nonlocal off
            ln, = _struct.unpack("<Q", raw[off:off + 8])
            off += 8
            blob = raw[off:off + ln]
            off += ln
            return blob

        if not self.pack_lwe:
            pos = self._output_positions()
            rows = []
            for li in range(0, self.batch_size, self.batch_block):
                ui = min(li + self.batch_block, self.batch_size)
                row = []
                for lj in range(0, self.output_dims, self.output_block):
                    uj = min(lj + self.output_block, self.output_dims)
                    required = [pos(i - li, j - lj)
                                for i in range(li, ui) for j in range(lj, uj)]
                    row.append(ser.load_terms(next_blob(), context, required))
                rows.append(row)
            return Cipher2d(rows)
        count = ceil_div(ceil_div(self.batch_size, self.batch_block)
                         * ceil_div(self.output_dims, self.output_block),
                         self.input_block)
        return Cipher2d([[ser.load_ciphertext(next_blob(), context)
                          for _ in range(count)]])


class Conv2dHelper:
    """Coefficient-packed 2-D convolution (LinearHelper.cuh:753-1195)."""

    def __init__(self, batch_size: int, image_height: int, image_width: int,
                 kernel_height: int, kernel_width: int, input_channels: int,
                 output_channels: int, slot_count: int, objective: int = 0):
        self.batch_size = batch_size
        self.image_height = image_height
        self.image_width = image_width
        self.kernel_height = kernel_height
        self.kernel_width = kernel_width
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.slot_count = slot_count
        self.objective = objective
        self._determine_block()

    def _determine_block(self):
        bs, H, W = self.batch_size, self.image_height, self.image_width
        kh, kw = self.kernel_height, self.kernel_width
        ci_all, co_all, slots = (self.input_channels, self.output_channels,
                                 self.slot_count)
        best = None
        c_best = 2 ** 31 - 1
        for b in range(bs, 0, -1):
            for h in range(min(H, slots // b), kh - 1, -1):
                for w in range(min(W, slots // b // h), kw - 1, -1):
                    for co in range(min(co_all, slots // b // h // w), 0, -1):
                        ci = min(slots // b // h // w // co, ci_all)
                        if ci == 0:
                            continue
                        blocks = (ceil_div(bs, b)
                                  * ceil_div(H - kh + 1, h - kh + 1)
                                  * ceil_div(W - kw + 1, w - kw + 1))
                        in_sz = blocks * ceil_div(ci_all, ci)
                        out_sz = blocks * ceil_div(co_all, co)
                        w_sz = ceil_div(ci_all, ci) * ceil_div(co_all, co)
                        if self.objective == 0:
                            c = in_sz + out_sz
                        elif self.objective == 1:
                            c = w_sz + out_sz
                        elif self.objective == 2:
                            c = in_sz + out_sz + w_sz
                        else:
                            raise ValueError("invalid objective")
                        if c < c_best:
                            c_best = c
                            best = (b, h, w, ci, co)
        if best is None:
            raise ValueError("no feasible conv tiling")
        (self.block_batch, self.block_height, self.block_width,
         self.block_in_channels, self.block_out_channels) = best

    def total_batch_size(self) -> int:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        sh = ceil_div(self.image_height - kh, self.block_height - kh)
        sw = ceil_div(self.image_width - kw, self.block_width - kw)
        return ceil_div(self.batch_size, self.block_batch) * sh * sw

    def encode_weights(self, encode_poly, weights: np.ndarray) -> Plain2d:
        """weights: (out_channels, in_channels, kh, kw), kernel flipped into
        reversed-channel block positions (LinearHelper.cuh:866-903)."""
        weights = np.asarray(weights)
        kh, kw = self.kernel_height, self.kernel_width
        bh, bw = self.block_height, self.block_width
        bci, bco = self.block_in_channels, self.block_out_channels
        block = bh * bw
        rows = []
        for loc in range(0, self.output_channels, bco):
            uoc = min(loc + bco, self.output_channels)
            row = []
            for lic in range(0, self.input_channels, bci):
                uic = min(lic + bci, self.input_channels)
                spread = np.zeros(bci * bco * block, dtype=weights.dtype)
                for oc in range(loc, uoc):
                    for ic in range(lic, uic):
                        base = ((oc - loc) * bci + (bci - 1 - (ic - lic))) * block
                        flipped = weights[oc, ic, ::-1, ::-1]
                        for ki in range(kh):
                            spread[base + ki * bw: base + ki * bw + kw] = \
                                flipped[ki]
                row.append(encode_poly(spread))
            rows.append(row)
        return Plain2d(rows)

    def encode_inputs(self, encode_poly, inputs: np.ndarray) -> Plain2d:
        """inputs: (batch, in_channels, H, W) (LinearHelper.cuh:918-966)."""
        inputs = np.asarray(inputs)
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        bh, bw = self.block_height, self.block_width
        bci, bco = self.block_in_channels, self.block_out_channels
        sh = ceil_div(self.image_height - kh, bh - kh)
        sw = ceil_div(self.image_width - kw, bw - kw)
        block = bh * bw
        rows = []
        for lb in range(0, self.batch_size, self.block_batch):
            ub = min(lb + self.block_batch, self.batch_size)
            for ih in range(sh):
                for iw in range(sw):
                    si, sj = ih * (bh - kh), iw * (bw - kw)
                    ui = min(si + bh, self.image_height)
                    uj = min(sj + bw, self.image_width)
                    group = []
                    for lci in range(0, self.input_channels, bci):
                        uci = min(lci + bci, self.input_channels)
                        vec = np.zeros(self.slot_count, dtype=inputs.dtype)
                        for b in range(ub - lb):
                            for tci in range(uci - lci):
                                base = (b * bci * bco + tci) * block
                                patch = inputs[lb + b, lci + tci, si:ui, sj:uj]
                                for ti in range(patch.shape[0]):
                                    vec[base + ti * bw:
                                        base + ti * bw + patch.shape[1]] = patch[ti]
                        group.append(encode_poly(vec))
                    rows.append(group)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor, encode_poly,
                       inputs) -> Cipher2d:
        # symmetric, as the reference (LinearHelper.cuh:208-215)
        return self.encode_inputs(encode_poly,
                                  inputs).encrypt_symmetric(encryptor)

    def conv2d(self, ev: Evaluator, a: Cipher2d, w: Plain2d) -> Cipher2d:
        """out[b, oc] = sum_i a[b, i] (*) w[oc, i]: one fused contraction
        over all (batch x out-channel-group x in-channel) tiles
        (LinearHelper.cuh Conv2dHelper::conv2d)."""
        return _run_tile_contraction(ev, a, w, transpose_ct=False,
                                     transpose_pt=True, transpose_out=False)

    def conv2d_cipher(self, ev: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        """ct x ct convolution: out[b, oc] = sum_i mult(a[b, i], w[oc, i]),
        one fused contraction (w transposed to the (i, oc) layout)."""
        return _run_cipher_contraction(ev, a, w, transpose_w=True)

    def conv2d_reverse(self, ev: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        """Encrypted weights, plain inputs: out[b, oc] = sum_i w[oc, i] (*)
        a[b, i] — the conv analogue of matmul_reverse, used for
        weight-private protocols (reference:
        app/LinearHelper.cuh:1020-1043 conv2dReverse; bound as a conv2d
        overload at binder/binder.cu:830-831). The ciphertext grid is the
        weight grid (oc, i) and the plain input grid (b, i) is transposed
        to (i, b); the (oc, b) result transposes back to (b, oc)."""
        return _run_tile_contraction(ev, w, a, transpose_ct=False,
                                     transpose_pt=True, transpose_out=True)

    def _mask_index(self, b, c, i, j, yh, yw):
        bci, bco = self.block_in_channels, self.block_out_channels
        interval = self.block_height * self.block_width
        return ((b * bci * bco + c * bci + bci - 1) * interval
                + (self.block_height - yh + i) * self.block_width
                + (self.block_width - yw + j))

    def decrypt_outputs(self, decode_poly, decryptor: Decryptor,
                        outputs: Cipher2d) -> np.ndarray:
        """Returns (batch, out_channels, H-kh+1, W-kw+1)
        (LinearHelper.cuh:1090-1135)."""
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh = self.block_height - kh
        yw = self.block_width - kw
        oyh = self.image_height - kh
        oyw = self.image_width - kw
        sh = ceil_div(self.image_height - kh, self.block_height - kh)
        sw = ceil_div(self.image_width - kw, self.block_width - kw)
        bco = self.block_out_channels
        ret = np.zeros((self.batch_size, self.output_channels, oyh, oyw),
                       dtype=np.object_)
        groups = ceil_div(self.output_channels, bco)
        flat = [outputs[eb][g] for eb in range(self.total_batch_size())
                for g in range(groups)]
        plains = decryptor.decrypt_many(flat)       # one dispatch+transfer
        bufs = [decode_poly(p) for p in plains]
        for eb in range(self.total_batch_size()):
            ob = eb // (sh * sw)
            si = (eb % (sh * sw)) // sw
            sj = eb % sw
            lb = ob * self.block_batch
            ub = min(lb + self.block_batch, self.batch_size)
            for lc in range(0, self.output_channels, bco):
                uc = min(lc + bco, self.output_channels)
                buf = bufs[eb * groups + lc // bco]
                for b in range(lb, ub):
                    for c in range(lc, uc):
                        for i in range(yh):
                            for j in range(yw):
                                if si * yh + i < oyh and sj * yw + j < oyw:
                                    ret[b, c, si * yh + i, sj * yw + j] = \
                                        buf[self._mask_index(b - lb, c - lc,
                                                             i, j, yh, yw)]
        return ret

    def encode_outputs(self, encode_poly, outputs: np.ndarray) -> Plain2d:
        """Encode (batch, out_channels, H-kh+1, W-kw+1) outputs into the
        conv's packed layout (LinearHelper.cuh encodeOutputs on
        Conv2dHelper) — for server-side masking of results."""
        outputs = np.asarray(outputs)
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh = self.block_height - kh
        yw = self.block_width - kw
        oyh = self.image_height - kh
        oyw = self.image_width - kw
        if outputs.shape != (self.batch_size, self.output_channels, oyh, oyw):
            raise ValueError("outputs shape incorrect")
        sh = ceil_div(self.image_height - kh, self.block_height - kh)
        sw = ceil_div(self.image_width - kw, self.block_width - kw)
        bco = self.block_out_channels
        rows = []
        for eb in range(self.total_batch_size()):
            ob = eb // (sh * sw)
            si = (eb % (sh * sw)) // sw
            sj = eb % sw
            lb = ob * self.block_batch
            ub = min(lb + self.block_batch, self.batch_size)
            group = []
            for lc in range(0, self.output_channels, bco):
                uc = min(lc + bco, self.output_channels)
                vec = np.zeros(self.slot_count, dtype=outputs.dtype)
                for b in range(lb, ub):
                    for c in range(lc, uc):
                        for i in range(yh):
                            for j in range(yw):
                                if si * yh + i < oyh and sj * yw + j < oyw:
                                    vec[self._mask_index(
                                        b - lb, c - lc, i, j, yh, yw)] = \
                                        outputs[b, c, si * yh + i,
                                                sj * yw + j]
                group.append(encode_poly(vec))
            rows.append(group)
        return Plain2d(rows)

    def serialize_outputs(self, ev: Evaluator, context: HeContext,
                          x: Cipher2d) -> bytes:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh = self.block_height - kh
        yw = self.block_width - kw
        required = [self._mask_index(b, c, i, j, yh, yw)
                    for b in range(self.block_batch)
                    for c in range(self.block_out_channels)
                    for i in range(yh) for j in range(yw)]
        out = []
        groups = ceil_div(self.output_channels, self.block_out_channels)
        flat = [x[b][oc] for b in range(self.total_batch_size())
                for oc in range(groups)]
        hosts = ser.fetch_ciphertexts_host(flat, context, to_coeff=True)
        for ct, h in zip(flat, hosts):
            blob = ser.save_terms(ct, context, required, host_coeff_data=h)
            out.append(_struct.pack("<Q", len(blob)))
            out.append(blob)
        return b"".join(out)

    def deserialize_outputs(self, ev: Evaluator, context: HeContext,
                            raw: bytes) -> Cipher2d:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh = self.block_height - kh
        yw = self.block_width - kw
        required = [self._mask_index(b, c, i, j, yh, yw)
                    for b in range(self.block_batch)
                    for c in range(self.block_out_channels)
                    for i in range(yh) for j in range(yw)]
        off = 0
        groups = ceil_div(self.output_channels, self.block_out_channels)
        rows = []
        for b in range(self.total_batch_size()):
            row = []
            for oc in range(groups):
                ln, = _struct.unpack("<Q", raw[off:off + 8])
                off += 8
                row.append(ser.load_terms(raw[off:off + ln], context, required))
                off += ln
            rows.append(row)
        return Cipher2d(rows)
