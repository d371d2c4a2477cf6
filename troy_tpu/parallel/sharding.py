"""Multi-device execution: device meshes and sharded ciphertext batches.

The reference is strictly single-GPU (cudaSetDevice(0) hard-coded,
reference: src/kernelprovider.cuh:30; no NCCL/MPI anywhere) — its only
parallelism is SIMT within one card. This module goes beyond it over a
``jax.sharding.Mesh`` of the cards of one host, which NVLink joins all
to all (every card reaches every other at the same rate, so a mesh's
shape follows the algorithm alone): ciphertext-batch data parallelism,
RNS-limb tensor parallelism, the coefficient-sharded NTT, and the
combined 2-D regime — all derived from sharding annotations (annotate,
compile, let GSPMD place the collectives, which XLA hands to NCCL).

Covered op surface (SURVEY.md section 2.2 mapping):
- multiply+relinearize (the headline op) under all four regimes,
- Galois/rotation (permute + key switch) under limb and 2-D regimes,
- mod-switch / CKKS rescale under limb and 2-D regimes,
- the app-layer matmul tile contraction under DP.

Every regime builder places the tables and keys on the mesh once, when
it is built (replicated, or split like the data they meet), so no call
copies them between devices.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..context import HeContext, ContextData
from ..he_types import Ciphertext, RelinKeys, GaloisKeys
from ..params import SchemeType
from .. import evaluator as ev_mod
from ..utils import galois as galois_util


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "dp") -> Mesh:
    """A 1-D device mesh over the first n_devices local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_2d(dp: int, tp: int,
                 axis_names: Sequence[str] = ("dp", "tp")) -> Mesh:
    """A (dp, tp) 2-D mesh: batch parallelism on the outer axis,
    limb/tensor parallelism on the inner axis."""
    devs = jax.devices()
    if dp * tp > len(devs):
        raise ValueError(f"mesh {dp}x{tp} exceeds {len(devs)} devices")
    return Mesh(np.array(devs[:dp * tp]).reshape(dp, tp),
                tuple(axis_names))


def shard_batch(mesh: Mesh, data: jnp.ndarray,
                axis_name: str = "dp") -> jnp.ndarray:
    """Place a (B, ...) batch with its leading axis split over the mesh."""
    spec = P(axis_name, *([None] * (data.ndim - 1)))
    return jax.device_put(data, NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# shared step builders
#
# cd/key/key_cd are jit ARGUMENTS (replicated), never closures: a
# closed-over device array becomes an embedded constant — a trace-time
# device readback and a far slower executable.
# ---------------------------------------------------------------------------

def _mult_relin_step(scheme: SchemeType):
    """One fused multiply+relinearize on raw ciphertext data:
    (2,k,n) x (2,k,n) -> (2,k,n)."""
    is_ntt = scheme in (SchemeType.ckks, SchemeType.bgv)

    def one(d1, d2, cd, key, key_cd):
        if scheme == SchemeType.bfv:
            prod = ev_mod._bfv_multiply(d1, d2, cd)
        else:
            prod = ev_mod._ntt_form_multiply(d1, d2, cd)
        delta = ev_mod._switch_key_core(prod[2], key, cd, key_cd, is_ntt)
        c0 = ev_mod._add(prod[0][None], delta[0][None], cd)[0]
        c1 = ev_mod._add(prod[1][None], delta[1][None], cd)[0]
        return jnp.stack([c0, c1])

    return one


def _galois_step(is_ntt_form: bool):
    """One fused Galois automorphism + key switch on raw data.

    NTT form: one(data, perm, key, cd, key_cd); coeff form:
    one(data, src, keep, key, cd, key_cd) — matching the evaluator's
    _apply_galois_{ntt,coeff}_core internals."""
    if is_ntt_form:
        def one(data, perm, key, cd, key_cd):
            c0 = ev_mod._apply_permutation(data[0], perm)
            c1 = ev_mod._apply_permutation(data[1], perm)
            delta = ev_mod._switch_key_core(c1, key, cd, key_cd, True)
            c0 = ev_mod._add(c0[None], delta[0][None], cd)[0]
            return jnp.stack([c0, delta[1]])
    else:
        def one(data, src, keep, key, cd, key_cd):
            c0 = ev_mod._apply_permutation_signed(data[0], src, keep, cd)
            c1 = ev_mod._apply_permutation_signed(data[1], src, keep, cd)
            delta = ev_mod._switch_key_core(c1, key, cd, key_cd, False)
            c0 = ev_mod._add(c0[None], delta[0][None], cd)[0]
            return jnp.stack([c0, delta[1]])
    return one


def _mod_switch_step(scheme: SchemeType):
    """Drop-one-prime scale: BFV divide-and-round, CKKS rescale, BGV
    mod-t-and-divide. (size,k,n) -> (size,k-1,n)."""
    if scheme == SchemeType.bfv:
        return lambda data, cd: ev_mod._bfv_mod_switch_scale(data, cd)
    if scheme == SchemeType.ckks:
        return lambda data, cd: ev_mod._ckks_rescale(data, cd)
    return lambda data, cd: ev_mod._bgv_mod_switch_scale(data, cd)


def _runner(jitted, mesh: Mesh, const_args, const_specs):
    """Bind the tables/keys once, placed as the jitted program expects:
    replicated on every device of the mesh (spec None) or split by their
    own spec. Left uncommitted, they would sit on device 0 and be copied
    to every device on every call."""
    placed = tuple(jax.device_put(
        a, NamedSharding(mesh, P()) if spec is None else spec)
        for a, spec in zip(const_args, const_specs))

    def run(*data_args):
        return jitted(*data_args, *placed)
    run.jitted = jitted          # exposed for HLO inspection in tests
    run.args = placed
    return run


def _level_cd(context: HeContext, level: Optional[int]) -> ContextData:
    return context.get_context_data(
        context.first_level if level is None else level)


# ---------------------------------------------------------------------------
# multiply + relinearize regimes
# ---------------------------------------------------------------------------

def batched_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                           mesh: Mesh, axis_name: str = "dp"):
    """Jitted data-parallel batch op: (B, 2, k, n) x2 -> (B, 2, k, n)
    multiply+relinearize, batch axis sharded over the mesh.

    XLA sees fully replicated tables/keys and a batch-sharded data axis, so
    the compiled program runs each shard's ciphertexts locally with zero
    collectives — the DP layout the reference cannot express at all.
    """
    one = _mult_relin_step(context.scheme)
    batched = jax.vmap(one, in_axes=(0, 0, None, None, None))
    spec = NamedSharding(mesh, P(axis_name))
    jitted = jax.jit(batched, in_shardings=(spec, spec, None, None, None),
                     out_shardings=spec)
    return _runner(jitted, mesh, (context.first_context_data,
                                  relin_keys.keys[2],
                                  context.key_context_data),
                   (None, None, None))


def limb_sharded_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                                mesh: Mesh, axis_name: str = "dp",
                                level: Optional[int] = None):
    """Single-ciphertext multiply+relinearize with the RNS-LIMB axis
    sharded over the mesh (tensor-parallel analogue; SURVEY.md section 2.2
    mapping: "RNS-limb sharding").

    Elementwise ops and the per-limb NTT are embarrassingly parallel
    across limbs; the cross-limb contractions — the BEHZ base conversions
    (q -> Bsk) and the key-switch inner product over decomposition limbs —
    have their reduction axis sharded, so GSPMD lowers them to local
    partial products + a cross-device reduce (psum), the pattern a
    hand-written multi-GPU port would issue through NCCL.

    The level's data-limb count must divide by the mesh size (the key
    is cut to the decomposition rows that level consumes, so it splits
    the same way).
    """
    cd = _level_cd(context, level)
    one = _mult_relin_step(context.scheme)
    # (size, k, n): shard the limb axis; the ksk (decomp, 2, key_limbs, n)
    # shards its decomposition axis to match the data limbs it consumes.
    spec = NamedSharding(mesh, P(None, axis_name, None))
    key_spec = NamedSharding(mesh, P(axis_name, None, None, None))
    jitted = jax.jit(one, in_shardings=(spec, spec, None, key_spec, None),
                     out_shardings=spec)
    return _runner(jitted, mesh, (cd, relin_keys.keys[2][:cd.limbs],
                                  context.key_context_data),
                   (None, key_spec, None))


def dp_limb_sharded_multiply_relin(context: HeContext,
                                   relin_keys: RelinKeys, mesh: Mesh,
                                   dp_axis: str = "dp",
                                   tp_axis: str = "tp",
                                   level: Optional[int] = None):
    """Combined DP x limb regime over a 2-D mesh: ciphertext batches split
    over the outer axis, each ciphertext's RNS limbs split over the inner
    axis. The limb-axis contractions (BEHZ base conversion, key-switch
    inner product) reduce within a dp group; no cross-group communication
    exists."""
    cd = _level_cd(context, level)
    one = _mult_relin_step(context.scheme)
    batched = jax.vmap(one, in_axes=(0, 0, None, None, None))
    # (B, size, k, n): batch over dp, limbs over tp; the ksk decomposition
    # axis follows the data limbs it consumes (replicated across dp).
    spec = NamedSharding(mesh, P(dp_axis, None, tp_axis, None))
    key_spec = NamedSharding(mesh, P(tp_axis, None, None, None))
    jitted = jax.jit(batched,
                     in_shardings=(spec, spec, None, key_spec, None),
                     out_shardings=spec)
    return _runner(jitted, mesh, (cd, relin_keys.keys[2][:cd.limbs],
                                  context.key_context_data),
                   (None, key_spec, None))


def coeff_sharded_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                                 mesh: Mesh, axis_name: str = "dp"):
    """Single-ciphertext multiply+relinearize with the COEFFICIENT axis
    sharded over the mesh — the reference's impossible-by-design scaling
    axis (its N<=131072 ceiling is one GPU, defines.h:30).

    GSPMD partitions the elementwise work over the coefficient axis and
    inserts the collectives the NTT's butterfly rounds need across shards
    (all-to-all / collective-permute), from the sharding annotations
    alone.
    """
    one = _mult_relin_step(context.scheme)
    # (size, k, n): shard the polynomial-coefficient axis; tables/keys are
    # replicated (see batched_multiply_relin note).
    spec = NamedSharding(mesh, P(None, None, axis_name))
    jitted = jax.jit(one, in_shardings=(spec, spec, None, None, None),
                     out_shardings=spec)
    return _runner(jitted, mesh, (context.first_context_data,
                                  relin_keys.keys[2],
                                  context.key_context_data),
                   (None, None, None))


# ---------------------------------------------------------------------------
# Galois / rotation regimes
# ---------------------------------------------------------------------------

def _galois_tables(context: HeContext, elt: int, is_ntt: bool):
    n = context.n
    if is_ntt:
        return (galois_util.ntt_permutation_dev(n, elt),)
    return galois_util.coeff_permutation_dev(n, elt)    # (src, keep)


def limb_sharded_galois(context: HeContext, galois_keys: GaloisKeys,
                        elt: int, mesh: Mesh, axis_name: str = "dp"):
    """Galois automorphism + key switch with the RNS-limb axis sharded:
    the permutation is elementwise per limb (no communication); the
    key-switch decomposition contraction reduces across devices (psum), like
    the relinearization it shares _switch_key_core with. Returned runner
    takes the raw (2, k, n) data."""
    is_ntt = context.scheme in (SchemeType.ckks, SchemeType.bgv)
    one = _galois_step(is_ntt)
    tables = _galois_tables(context, elt, is_ntt)
    spec = NamedSharding(mesh, P(None, axis_name, None))
    key_spec = NamedSharding(mesh, P(axis_name, None, None, None))
    in_shardings = (spec,) + (None,) * len(tables) + (key_spec, None, None)
    jitted = jax.jit(one, in_shardings=in_shardings, out_shardings=spec)
    cd = context.first_context_data
    return _runner(jitted, mesh, (*tables, galois_keys.keys[elt][:cd.limbs],
                                  cd, context.key_context_data),
                   in_shardings[1:])


def dp_limb_sharded_galois(context: HeContext, galois_keys: GaloisKeys,
                           elt: int, mesh: Mesh, dp_axis: str = "dp",
                           tp_axis: str = "tp"):
    """Batched Galois under the 2-D regime: (B, 2, k, n) with batches over
    dp and limbs over tp (the same layout the 2-D mult+relin uses, so the
    two ops chain with no resharding)."""
    is_ntt = context.scheme in (SchemeType.ckks, SchemeType.bgv)
    one = _galois_step(is_ntt)
    tables = _galois_tables(context, elt, is_ntt)
    n_tab = len(tables)
    batched = jax.vmap(one, in_axes=(0,) + (None,) * (n_tab + 3))
    spec = NamedSharding(mesh, P(dp_axis, None, tp_axis, None))
    key_spec = NamedSharding(mesh, P(tp_axis, None, None, None))
    in_shardings = (spec,) + (None,) * n_tab + (key_spec, None, None)
    jitted = jax.jit(batched, in_shardings=in_shardings, out_shardings=spec)
    cd = context.first_context_data
    return _runner(jitted, mesh, (*tables, galois_keys.keys[elt][:cd.limbs],
                                  cd, context.key_context_data),
                   in_shardings[1:])


def limb_sharded_rotate(context: HeContext, galois_keys: GaloisKeys,
                        steps: int, mesh: Mesh, axis_name: str = "dp"):
    """rotate_rows/rotate_vector by `steps` under the limb regime (the
    Galois element is 3^steps mod 2n, galois.h:68)."""
    elt = galois_util.get_elt_from_step(context.n, steps)
    return limb_sharded_galois(context, galois_keys, elt, mesh, axis_name)


def dp_limb_sharded_rotate(context: HeContext, galois_keys: GaloisKeys,
                           steps: int, mesh: Mesh, dp_axis: str = "dp",
                           tp_axis: str = "tp"):
    elt = galois_util.get_elt_from_step(context.n, steps)
    return dp_limb_sharded_galois(context, galois_keys, elt, mesh,
                                  dp_axis, tp_axis)


# ---------------------------------------------------------------------------
# mod-switch / rescale regimes
# ---------------------------------------------------------------------------

def limb_sharded_mod_switch(context: HeContext, mesh: Mesh,
                            axis_name: str = "dp",
                            level: Optional[int] = None):
    """Drop-one-prime mod switch (BFV) / rescale (CKKS) / BGV variant with
    the limb axis sharded: each output limb needs only its own residue and
    the dropped last limb, which GSPMD broadcasts from its owner
    (collective-permute / all-gather of one limb — k-fold smaller than the
    data). Runner takes raw (size, k, n) data, returns (size, k-1, n)."""
    cd = _level_cd(context, level)
    step = _mod_switch_step(context.scheme)
    spec = NamedSharding(mesh, P(None, axis_name, None))
    # the output has k-1 limbs (often not divisible by the mesh): let
    # GSPMD pick its layout rather than force a partition
    jitted = jax.jit(step, in_shardings=(spec, None))
    return _runner(jitted, mesh, (cd,), (None,))


def dp_limb_sharded_mod_switch(context: HeContext, mesh: Mesh,
                               dp_axis: str = "dp", tp_axis: str = "tp",
                               level: Optional[int] = None):
    """Batched mod switch under the 2-D regime: (B, size, k, n) ->
    (B, size, k-1, n), batches over dp, limbs over tp."""
    cd = _level_cd(context, level)
    step = _mod_switch_step(context.scheme)
    batched = jax.vmap(step, in_axes=(0, None))
    spec = NamedSharding(mesh, P(dp_axis, None, tp_axis, None))
    out_spec = NamedSharding(mesh, P(dp_axis, None, None, None))
    jitted = jax.jit(batched, in_shardings=(spec, None),
                     out_shardings=out_spec)
    return _runner(jitted, mesh, (cd,), (None,))


# ---------------------------------------------------------------------------
# app layer
# ---------------------------------------------------------------------------

def sharded_app_matmul(ev, mesh: Mesh, a2d, w2d, axis_name: str = "dp"):
    """The app-layer coefficient-packed matmul with its batch-block tile
    axis sharded over the mesh (BASELINE config 5: the LinearHelper
    pipeline across chips/hosts). Each device holds a slice of the input
    batch blocks and computes its output tiles locally — zero collectives.
    Weights/tables replicate.

    a2d: Cipher2d from helper.encrypt_inputs (batch-block rows);
    w2d: Plain2d from helper.encode_weights. Returns a Cipher2d with the
    same layout as helper.matmul (same contraction code path)."""
    from ..app import linear as lin

    spec = NamedSharding(mesh, P(axis_name, None, None, None, None))
    return lin._run_tile_contraction(ev, a2d, w2d, transpose_ct=False,
                                     transpose_pt=False, transpose_out=False,
                                     ct_sharding=spec)
