"""HE context: parameter validation and the modulus-switching chain.

Semantics-compatible with the reference's context layer
(reference: src/context.h:244-669, src/context.cpp, src/context_cuda.cuh:11-205):
one ``ContextData`` per chain level — level 0 holds the full modulus ("key
level"), each subsequent level drops the last prime — carrying every
precomputation the actors need: NTT tables (device twins), the RNS/BEHZ tool,
BFV plain-lift scalars, and batching tables.

``ContextData`` is a pytree whose leaves are the device NTT tables and whose static fields are hashable Python scalars, so a whole
level can ride through ``jax.jit`` and every modulus constant specializes
into the compiled executable.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
from .utils import struct

from .modulus import Modulus, SecurityLevel
from .params import (
    EncryptionParameters, EncryptionParameterQualifiers, ParmsID,
    SchemeType, validate,
)
from .utils.ntt_tables import make_ntt_tables
from .utils.rns import RnsTool, make_rns_tool
from .ops.ntt import NttTables, RnsNttTables


class ContextData(struct.PyTreeNode):
    """One level of the modulus-switching chain (context.h:437-475)."""

    # -- dynamic leaves: device-resident precomputed tables --
    ntt: RnsNttTables                       # stacked over this level's primes
    bsk_ntt: Optional[RnsNttTables]         # BEHZ aux base (BFV only)
    plain_ntt: Optional[NttTables]          # batching tables mod t (or None)

    # -- static metadata (hashable; specializes every jit) --
    parms: EncryptionParameters = struct.field(pytree_node=False)
    chain_index: int = struct.field(pytree_node=False)   # 0 = key level
    qualifiers: EncryptionParameterQualifiers = struct.field(pytree_node=False)
    rns_tool: RnsTool = struct.field(pytree_node=False)
    total_coeff_modulus: int = struct.field(pytree_node=False)
    # BFV/BGV plain-embedding scalars (context.cpp analogues)
    coeff_div_plain_modulus: Tuple[int, ...] = struct.field(pytree_node=False)
    plain_upper_half_threshold: int = struct.field(pytree_node=False)
    plain_upper_half_increment: Tuple[int, ...] = struct.field(pytree_node=False)
    upper_half_threshold: Tuple[int, ...] = struct.field(pytree_node=False)
    upper_half_increment: Tuple[int, ...] = struct.field(pytree_node=False)
    coeff_modulus_mod_plain_modulus: int = struct.field(pytree_node=False)

    # ---- conveniences ----
    @property
    def scheme(self) -> SchemeType:
        return self.parms.scheme

    @property
    def n(self) -> int:
        return self.parms.poly_modulus_degree

    @property
    def coeff_modulus(self) -> Tuple[Modulus, ...]:
        return self.parms.coeff_modulus

    @property
    def coeff_values(self) -> Tuple[int, ...]:
        return self.parms.coeff_values

    @property
    def limbs(self) -> int:
        return len(self.parms.coeff_modulus)

    @property
    def plain_modulus(self) -> Modulus:
        return self.parms.plain_modulus

    @property
    def parms_id(self) -> ParmsID:
        return self.parms.parms_id


def _build_context_data(parms: EncryptionParameters, chain_index: int,
                        qualifiers: EncryptionParameterQualifiers,
                        internal_prime_bits: int = None) -> ContextData:
    n = parms.poly_modulus_degree
    values = parms.coeff_values
    t = int(parms.plain_modulus)

    ntt = RnsNttTables.from_moduli(n, values)

    plain_ntt = None
    if qualifiers.using_batching:
        plain_ntt = NttTables.from_host(make_ntt_tables(n, t))

    from .modulus import INTERNAL_MOD_BIT_COUNT
    rns_tool = make_rns_tool(n, values,
                             t if parms.scheme != SchemeType.ckks else 0,
                             internal_prime_bits or INTERNAL_MOD_BIT_COUNT)

    bsk_ntt = None
    if parms.scheme == SchemeType.bfv:
        bsk_ntt = RnsNttTables.from_moduli(n, rns_tool.base_Bsk.values)

    Q = 1
    for v in values:
        Q *= v

    if t:
        delta = Q // t
        coeff_div_plain = tuple(delta % v for v in values)
        put = (t + 1) >> 1
        if qualifiers.using_fast_plain_lift:
            # each limb lifts independently: add (q_i - t) to upper-half coeffs
            plain_upper_inc = tuple(v - t for v in values)
        else:
            # add (Q - t) decomposed in RNS
            plain_upper_inc = tuple((Q - t) % v for v in values)
        upper_half_threshold = tuple(((Q + 1) >> 1) % v for v in values)
        upper_half_increment = tuple((Q - t) % v for v in values)
        q_mod_t = Q % t
    else:
        coeff_div_plain = ()
        put = 0
        plain_upper_inc = ()
        upper_half_threshold = tuple(((Q + 1) >> 1) % v for v in values)
        upper_half_increment = ()
        q_mod_t = 0

    return ContextData(
        ntt=ntt,
        bsk_ntt=bsk_ntt,
        plain_ntt=plain_ntt,
        parms=parms,
        chain_index=chain_index,
        qualifiers=qualifiers,
        rns_tool=rns_tool,
        total_coeff_modulus=Q,
        coeff_div_plain_modulus=coeff_div_plain,
        plain_upper_half_threshold=put,
        plain_upper_half_increment=plain_upper_inc,
        upper_half_threshold=upper_half_threshold,
        upper_half_increment=upper_half_increment,
        coeff_modulus_mod_plain_modulus=q_mod_t,
    )


class HeContext:
    """The validated parameter chain (context.h SEALContext analogue).

    ``chain[0]`` is the key level (full modulus); ``chain[1:]`` are data
    levels, each dropping one prime. Ciphertexts refer to levels by integer
    ``chain_index`` — a static value that specializes jit traces.
    """

    def __init__(self, parms: EncryptionParameters,
                 expand_mod_chain: bool = True,
                 sec_level: SecurityLevel = SecurityLevel.tc128,
                 internal_prime_bits: int = None):
        """``internal_prime_bits``: width of the BEHZ auxiliary-base primes.
        None/61 = reference parity (rns.cpp getPrimes(61, ...)); 34-60
        opts into a narrower auxiliary base, whose speed on the GPU is
        not measured yet (see utils/rns.RnsTool docstring for the
        correctness sizing)."""
        qualifiers = validate(parms, sec_level)
        if not qualifiers.parameters_set:
            raise ValueError(f"invalid encryption parameters: "
                             f"{qualifiers.error_message}")
        self.sec_level = sec_level
        self.internal_prime_bits = internal_prime_bits
        chain: List[ContextData] = [
            _build_context_data(parms, 0, qualifiers,
                                internal_prime_bits)]

        self._using_keyswitching = len(parms.coeff_modulus) > 1
        if self._using_keyswitching:
            level_parms = parms.drop_last()
            idx = 1
            while True:
                q = validate(level_parms, sec_level)
                if not q.parameters_set:
                    raise ValueError(f"invalid parameters at chain level {idx}: "
                                     f"{q.error_message}")
                chain.append(_build_context_data(level_parms, idx, q,
                                                 internal_prime_bits))
                if not expand_mod_chain or len(level_parms.coeff_modulus) == 1:
                    break
                level_parms = level_parms.drop_last()
                idx += 1

        self.chain: Tuple[ContextData, ...] = tuple(chain)
        self._by_parms_id = {cd.parms_id: cd for cd in chain}

    # ---- accessors (context.h:343-412 analogues) ----
    @property
    def key_context_data(self) -> ContextData:
        return self.chain[0]

    @property
    def first_context_data(self) -> ContextData:
        return self.chain[1] if self._using_keyswitching else self.chain[0]

    @property
    def last_context_data(self) -> ContextData:
        return self.chain[-1]

    @property
    def first_level(self) -> int:
        return 1 if self._using_keyswitching else 0

    @property
    def last_level(self) -> int:
        return len(self.chain) - 1

    def get_context_data(self, level: int) -> ContextData:
        return self.chain[level]

    def get_context_data_by_parms_id(self, pid: ParmsID) -> Optional[ContextData]:
        return self._by_parms_id.get(pid)

    @property
    def using_keyswitching(self) -> bool:
        return self._using_keyswitching

    @property
    def scheme(self) -> SchemeType:
        return self.chain[0].scheme

    @property
    def n(self) -> int:
        return self.chain[0].n

    # plain-NTT device tables are shared by every level; expose the key ones
    @property
    def plain_ntt(self) -> Optional[NttTables]:
        return self.chain[0].plain_ntt
