"""RNS (residue number system) precomputation — host side.

Semantics-compatible re-design of the reference's RNS toolchain
(reference: src/utils/rns.h:16-366, src/utils/rns.cpp:400-1148): CRT bases
with punctured products, base-change matrices, and the BEHZ tool bases
(B, Bsk = B ∪ {m_sk}, Bsk ∪ {m̃} with m̃ = 2^32, {t, γ}).

Everything here is computed once per context level with Python big ints and
stored as immutable tuples — the device ops (troy_tpu/ops/rns.py) consume
these as *static* trace-time constants, so the device executables carry no RNS
tables in memory at all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Tuple

from . import numth
from .ntt_tables import NttTablesHost, make_ntt_tables
from ..modulus import Modulus, INTERNAL_MOD_BIT_COUNT

M64 = (1 << 64) - 1


def _shoup(operand: int, q: int) -> int:
    return (operand << 64) // q


@dataclass(frozen=True)
class RnsBase:
    """A CRT base q_0..q_{k-1} of pairwise-coprime moduli with punctured
    products Q/q_i and their inverses mod q_i (rns.h RNSBase)."""

    moduli: Tuple[Modulus, ...]

    def __post_init__(self):
        vals = [int(m) for m in self.moduli]
        if not vals:
            raise ValueError("empty RNS base")
        for i in range(len(vals)):
            if vals[i] == 0:
                raise ValueError("zero modulus in base")
            for j in range(i + 1, len(vals)):
                if not numth.are_coprime(vals[i], vals[j]):
                    raise ValueError("RNS base moduli must be pairwise coprime")

    @property
    def size(self) -> int:
        return len(self.moduli)

    @property
    def values(self) -> Tuple[int, ...]:
        return tuple(int(m) for m in self.moduli)

    @property
    def base_prod(self) -> int:
        p = 1
        for m in self.moduli:
            p *= int(m)
        return p

    def punctured_prod(self, i: int) -> int:
        return self.base_prod // int(self.moduli[i])

    def inv_punctured(self, i: int) -> int:
        q = int(self.moduli[i])
        return numth.invert_mod(self.punctured_prod(i) % q, q)

    def contains(self, value: int) -> bool:
        return any(int(m) == value for m in self.moduli)

    def is_subbase_of(self, other: "RnsBase") -> bool:
        return all(other.contains(int(m)) for m in self.moduli)

    def extend(self, value: int) -> "RnsBase":
        return RnsBase(self.moduli + (Modulus(value),))

    def drop(self) -> "RnsBase":
        if self.size == 1:
            raise ValueError("cannot drop from base of size 1")
        return RnsBase(self.moduli[:-1])

    def decompose(self, value: int) -> Tuple[int, ...]:
        """Single big int -> residues."""
        return tuple(value % int(m) for m in self.moduli)

    def compose(self, residues) -> int:
        """Residues -> the unique representative in [0, Q)."""
        q = self.base_prod
        acc = 0
        for i, r in enumerate(residues):
            pp = self.punctured_prod(i)
            acc += (int(r) * self.inv_punctured(i) % int(self.moduli[i])) * pp
        return acc % q


@dataclass(frozen=True)
class BaseConverter:
    """Fast base conversion q -> p: static base-change matrix
    M[o][i] = (Q/q_i) mod p_o (rns.cpp BaseConverter::initialize)."""

    ibase: RnsBase
    obase: RnsBase
    # matrix[o][i], inv_punctured (+shoup) as plain int tuples
    matrix: Tuple[Tuple[int, ...], ...] = field(init=False)
    inv_punctured: Tuple[int, ...] = field(init=False)
    inv_punctured_shoup: Tuple[int, ...] = field(init=False)

    def __post_init__(self):
        mat = tuple(
            tuple(self.ibase.punctured_prod(i) % int(po) for i in range(self.ibase.size))
            for po in self.obase.moduli
        )
        invp = tuple(self.ibase.inv_punctured(i) for i in range(self.ibase.size))
        invs = tuple(_shoup(invp[i], int(self.ibase.moduli[i])) for i in range(self.ibase.size))
        object.__setattr__(self, "matrix", mat)
        object.__setattr__(self, "inv_punctured", invp)
        object.__setattr__(self, "inv_punctured_shoup", invs)

    def fast_convert_int(self, residues) -> Tuple[int, ...]:
        """Host oracle of the device fast_convert (for tests): approximate
        base conversion, output may carry an alpha*Q overshoot."""
        temp = [
            int(r) * self.inv_punctured[i] % int(self.ibase.moduli[i])
            for i, r in enumerate(residues)
        ]
        out = []
        for o, po in enumerate(self.obase.moduli):
            acc = sum(temp[i] * self.matrix[o][i] for i in range(self.ibase.size))
            out.append(acc % int(po))
        return tuple(out)


def _draw_aux_primes(factor: int, bit_size: int, forbidden: set,
                     bound: int, t: int = 0
                     ) -> Tuple[int, int, Tuple[int, ...]]:
    """Draw auxiliary primes of `bit_size` bits congruent 1 mod `factor`,
    skipping `forbidden` values (the q primes) and any prime FACTOR of
    `t` (a composite plain modulus can contain a bit_size-bit prime —
    sharing it would make gamma/m_sk non-invertible mod t): first m_sk,
    then gamma, then B primes until prod(B) * m_sk > bound (exact
    product); B always gets at least one prime (the BEHZ converters
    need a non-empty B base even when m_sk alone exceeds the bound)."""
    count = 8
    while True:
        cand = [p for p in numth.get_primes(factor, bit_size, count)
                if p not in forbidden and (t == 0 or t % p != 0)]
        if len(cand) >= 3:
            m_sk, gamma = cand[0], cand[1]
            b_primes = []
            prod = m_sk
            for p in cand[2:]:
                if b_primes and prod > bound:
                    break
                b_primes.append(p)
                prod *= p
            if b_primes and prod > bound:
                return m_sk, gamma, tuple(b_primes)
        count *= 2
        if count > 4096:   # ~> any real base; get_primes raises first anyway
            raise RuntimeError(
                f"cannot build a {bit_size}-bit auxiliary base large enough "
                f"for this coefficient modulus")


@dataclass(frozen=True)
class RnsTool:
    """Per-level RNS tool: the BEHZ auxiliary bases and every scalar
    precomputation needed by multiply / mod-switch / decrypt
    (rns.cpp:581-775). All fields are hashable Python ints/tuples so the
    whole object is a static jit argument.

    ``internal_prime_bits`` sets the bit width of the auxiliary-base primes
    (B, m_sk, gamma). The default (61, INTERNAL_MOD_BIT_COUNT) reproduces the
    reference's choice (rns.cpp:628-630 getPrimes(61, ...)) word for word.
    Narrower widths are an opt-in mode whose speed on the GPU is not
    measured yet. Correctness
    is preserved by sizing the base on EXACT products: the BEHZ bound
    requires prod(Bsk) > n * t * Q * (1+rho)^2 (rho ~ k/m_tilde); we enforce
    the strictly stronger prod(B) * m_sk > 2^33 * t * Q, which covers every
    n <= 2^30 (the framework caps n at 2^20). Aux primes are drawn skipping
    any value in base q or equal to t, so the coprimality the conversions
    need (Q^-1 mod b_i, etc.) always exists — at 61 bits the reference gets
    this for free because user primes are <= 60 bits."""

    n: int                          # poly_modulus_degree
    base_q: RnsBase
    t: int                          # plain modulus (0 for CKKS)
    internal_prime_bits: int = INTERNAL_MOD_BIT_COUNT

    base_B: RnsBase = field(init=False)
    base_Bsk: RnsBase = field(init=False)
    base_Bsk_m_tilde: RnsBase = field(init=False)
    base_t_gamma: Optional[RnsBase] = field(init=False)

    m_tilde: int = field(init=False)          # 2^32
    m_sk: int = field(init=False)
    gamma: int = field(init=False)

    conv_q_to_Bsk: BaseConverter = field(init=False)
    conv_q_to_m_tilde: BaseConverter = field(init=False)
    conv_B_to_q: BaseConverter = field(init=False)
    conv_B_to_m_sk: BaseConverter = field(init=False)
    conv_q_to_t_gamma: Optional[BaseConverter] = field(init=False)
    conv_q_to_t: Optional[BaseConverter] = field(init=False)

    # scalar precomputes (tuples indexed by limb)
    inv_prod_q_mod_Bsk: Tuple[int, ...] = field(init=False)
    neg_inv_prod_q_mod_m_tilde: int = field(init=False)
    inv_prod_B_mod_m_sk: int = field(init=False)
    inv_gamma_mod_t: int = field(init=False)
    prod_B_mod_q: Tuple[int, ...] = field(init=False)
    inv_m_tilde_mod_Bsk: Tuple[int, ...] = field(init=False)
    prod_q_mod_Bsk: Tuple[int, ...] = field(init=False)
    neg_inv_q_mod_t_gamma: Tuple[int, ...] = field(init=False)
    prod_t_gamma_mod_q: Tuple[int, ...] = field(init=False)
    inv_q_last_mod_q: Tuple[int, ...] = field(init=False)
    inv_q_last_mod_t: int = field(init=False)
    q_last_mod_t: int = field(init=False)

    def __post_init__(self):
        q = self.base_q
        t = self.t
        k = q.size
        total_coeff_bits = q.base_prod.bit_length()
        t_bits = t.bit_length() if t else 0

        b_bits = self.internal_prime_bits
        m_tilde = 1 << 32
        if b_bits == INTERNAL_MOD_BIT_COUNT:
            # Parity path: the reference's sizing heuristic, word for word
            # (rns.cpp:585-630): B has one prime per q limb, plus one if
            # m_tilde*t*Q could overflow the 61-bit capacity estimate.
            base_B_size = k
            if 32 + t_bits + total_coeff_bits >= INTERNAL_MOD_BIT_COUNT * k + INTERNAL_MOD_BIT_COUNT:
                base_B_size += 1
            aux = numth.get_primes(2 * self.n, INTERNAL_MOD_BIT_COUNT,
                                   base_B_size + 2)
            m_sk, gamma = aux[0], aux[1]
            b_primes = aux[2:2 + base_B_size]
        else:
            # Narrow internal base: size B on EXACT products so narrower
            # primes never violate the BEHZ bound (class docstring).
            if not 34 <= b_bits <= 60:
                raise ValueError(
                    "internal_prime_bits must be 61 (reference parity) or in "
                    f"[34, 60]; got {b_bits}")
            forbidden = set(q.values) | {t}
            m_sk, gamma, b_primes = _draw_aux_primes(
                2 * self.n, b_bits, forbidden,
                # prod(B)*m_sk must exceed 2^33 * t * Q (t=1 for CKKS)
                bound=(max(t, 1) * q.base_prod) << 33, t=t)
            base_B_size = len(b_primes)

        base_B = RnsBase(tuple(Modulus(p) for p in b_primes))
        base_Bsk = base_B.extend(m_sk)
        base_Bsk_m_tilde = base_Bsk.extend(m_tilde)
        base_t_gamma = RnsBase((Modulus(t), Modulus(gamma))) if t else None

        set_ = lambda name, v: object.__setattr__(self, name, v)
        set_("base_B", base_B)
        set_("base_Bsk", base_Bsk)
        set_("base_Bsk_m_tilde", base_Bsk_m_tilde)
        set_("base_t_gamma", base_t_gamma)
        set_("m_tilde", m_tilde)
        set_("m_sk", m_sk)
        set_("gamma", gamma)

        set_("conv_q_to_Bsk", BaseConverter(q, base_Bsk))
        set_("conv_q_to_m_tilde", BaseConverter(q, RnsBase((Modulus(m_tilde),))))
        set_("conv_B_to_q", BaseConverter(base_B, q))
        set_("conv_B_to_m_sk", BaseConverter(base_B, RnsBase((Modulus(m_sk),))))
        set_("conv_q_to_t_gamma", BaseConverter(q, base_t_gamma) if t else None)
        set_("conv_q_to_t", BaseConverter(q, RnsBase((Modulus(t),))) if t else None)

        Q = q.base_prod
        B_prod = base_B.base_prod
        set_("prod_B_mod_q", tuple(B_prod % v for v in q.values))
        set_("inv_prod_q_mod_Bsk",
             tuple(numth.invert_mod(Q % v, v) for v in base_Bsk.values))
        set_("inv_prod_B_mod_m_sk", numth.invert_mod(B_prod % m_sk, m_sk))
        set_("inv_m_tilde_mod_Bsk",
             tuple(numth.invert_mod(m_tilde % v, v) for v in base_Bsk.values))
        set_("neg_inv_prod_q_mod_m_tilde",
             (-numth.invert_mod(Q % m_tilde, m_tilde)) % m_tilde)
        set_("prod_q_mod_Bsk", tuple(Q % v for v in base_Bsk.values))

        if t:
            set_("inv_gamma_mod_t", numth.invert_mod(gamma % t, t))
            set_("prod_t_gamma_mod_q", tuple((t * gamma) % v for v in q.values))
            set_("neg_inv_q_mod_t_gamma",
                 tuple((-numth.invert_mod(Q % v, v)) % v for v in base_t_gamma.values))
        else:
            set_("inv_gamma_mod_t", 0)
            set_("prod_t_gamma_mod_q", ())
            set_("neg_inv_q_mod_t_gamma", ())

        q_last = q.values[-1]
        set_("inv_q_last_mod_q",
             tuple(numth.invert_mod(q_last % v, v) for v in q.values[:-1]))
        if t:
            set_("inv_q_last_mod_t", numth.invert_mod(q_last % t, t))
            set_("q_last_mod_t", q_last % t)
        else:
            set_("inv_q_last_mod_t", 1)
            set_("q_last_mod_t", 1)

    def bsk_ntt_tables(self) -> Tuple[NttTablesHost, ...]:
        """NTT tables over the Bsk base (for the BEHZ multiply)."""
        return tuple(make_ntt_tables(self.n, v) for v in self.base_Bsk.values)

    def __hash__(self):
        return hash((self.n, self.base_q.values, self.t,
                     self.internal_prime_bits))

    def __eq__(self, other):
        return (isinstance(other, RnsTool)
                and self.n == other.n
                and self.base_q.values == other.base_q.values
                and self.t == other.t
                and self.internal_prime_bits == other.internal_prime_bits)


@lru_cache(maxsize=None)
def make_rns_tool(n: int, q_values: Tuple[int, ...], t: int,
                  internal_prime_bits: int = INTERNAL_MOD_BIT_COUNT) -> RnsTool:
    return RnsTool(n=n, base_q=RnsBase(tuple(Modulus(v) for v in q_values)),
                   t=t, internal_prime_bits=internal_prime_bits)
