"""Randomized differential fuzzing: random op sequences per scheme checked
against a plaintext slot-model after every step. Complements the pinned
scenario tests (reference test/evaluator_cuda.cu style) with coverage of
op ORDER interactions — correction-factor balancing, scale tracking,
level changes, and rotation composition — that fixed scenarios miss.
Seeded, so failures replay deterministically."""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu import prng as rnd

N = 64
HALF = N // 2


def _build(scheme, q_bits, t_bits=None, seed=1):
    kwargs = {}
    if scheme != T.SchemeType.ckks:
        kwargs["plain_modulus"] = T.PlainModulus.batching(N, t_bits)
    parms = T.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, q_bits)), **kwargs)
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
    return ctx, kg


def _rot_rows_model(v, steps):
    return np.concatenate([np.roll(v[:HALF], -steps), np.roll(v[HALF:], -steps)])


@pytest.mark.parametrize("scheme", [T.SchemeType.bfv, T.SchemeType.bgv])
@pytest.mark.parametrize("fuzz_seed", [0, 1, 2])
def test_bfv_bgv_random_sequences(scheme, fuzz_seed):
    ctx, kg = _build(scheme, [40, 40, 40], t_bits=16, seed=101 + fuzz_seed)
    t = int(ctx.first_context_data.plain_modulus)
    rlk = kg.create_relin_keys()
    # rotate_columns needs the column-swap element 2N-1 on top of the
    # step elements (galois.h:68 getEltFromStep semantics)
    glk = kg.create_galois_keys(
        elts=list(T.utils.galois.get_elts_from_steps(N, [1, 2, 3, -1, -2, -3]))
        + [2 * N - 1])
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    rng = np.random.default_rng(900 + fuzz_seed)

    a = rng.integers(0, t, N, dtype=np.uint64)
    b = rng.integers(0, t, N, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    ct_other = enc.encrypt_symmetric(be.encode(b))
    model = a.astype(object)
    model_other = b.astype(object)
    mults_left = 2   # noise budget at N=64, 2 data primes

    ops = ["add", "sub", "negate", "add_plain", "sub_plain",
           "multiply_plain", "multiply", "square",
           "rotate_rows", "rotate_columns", "mod_switch"]
    for step_i in range(12):
        op = ops[rng.integers(len(ops))]
        if op == "add":
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.add(ct, ct_other)
            model = (model + model_other) % t
        elif op == "sub":
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.sub(ct, ct_other)
            model = (model - model_other) % t
        elif op == "negate":
            ct = ev.negate(ct)
            model = (-model) % t
        elif op in ("add_plain", "sub_plain", "multiply_plain"):
            p = rng.integers(0, t, N, dtype=np.uint64)
            pt = be.encode(p)
            if op == "add_plain":
                ct = ev.add_plain(ct, pt)
                model = (model + p.astype(object)) % t
            elif op == "sub_plain":
                ct = ev.sub_plain(ct, pt)
                model = (model - p.astype(object)) % t
            else:
                ct = ev.multiply_plain(ct, pt)
                model = (model * p.astype(object)) % t
        elif op == "multiply" and mults_left > 0:
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.relinearize(ev.multiply(ct, ct_other), rlk)
            model = (model * model_other) % t
            mults_left -= 1
        elif op == "square" and mults_left > 0:
            ct = ev.relinearize(ev.square(ct), rlk)
            model = (model * model) % t
            mults_left -= 1
        elif op == "rotate_rows":
            s = int(rng.integers(1, 4)) * int(rng.choice([-1, 1]))
            ct = ev.rotate_rows(ct, s, glk)
            model = _rot_rows_model(model, s)
        elif op == "rotate_columns":
            ct = ev.rotate_columns(ct, glk)
            model = np.concatenate([model[HALF:], model[:HALF]])
        elif op == "mod_switch" and ct.level + 1 < len(ctx.chain):
            ct = ev.mod_switch_to_next(ct)
            mults_left = 0   # too little room left; avoid noise overflow
        # noise-aware gate: a positive invariant noise budget guarantees
        # exact decryption (decryptor.py:166, reference decryptor.cpp) —
        # random multiply/multiply_plain chains at N=64 legitimately
        # exhaust the ~80-bit budget, which is not a correctness bug
        if dec.invariant_noise_budget(ct) <= 0:
            break
        got = be.decode(dec.decrypt(ct)).astype(object)
        assert np.array_equal(got, model % t), \
            f"{scheme.name} fuzz seed {fuzz_seed} diverged at step " \
            f"{step_i} ({op})"


@pytest.mark.parametrize("fuzz_seed", [0, 1, 2])
def test_ckks_random_sequences(fuzz_seed):
    # 40-bit scale over 40-bit middle primes: rescale keeps scale ~2^40,
    # so ct/ct_other stay composable across the whole sequence
    scale = float(1 << 40)
    ctx, kg = _build(T.SchemeType.ckks, [50, 40, 40, 50], seed=77 + fuzz_seed)
    rlk = kg.create_relin_keys()
    # complex_conjugate needs elt 2N-1 on top of the rotation elements
    glk = kg.create_galois_keys(
        elts=list(T.utils.galois.get_elts_from_steps(N, [1, 2, -1, -2]))
        + [2 * N - 1])
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    encd = T.CKKSEncoder(ctx)
    ev = T.Evaluator(ctx)
    rng = np.random.default_rng(300 + fuzz_seed)

    a = rng.uniform(-1, 1, HALF) + 1j * rng.uniform(-1, 1, HALF)
    b = rng.uniform(-1, 1, HALF) + 1j * rng.uniform(-1, 1, HALF)
    ct = enc.encrypt_symmetric(encd.encode(a, scale))
    ct_other = enc.encrypt_symmetric(encd.encode(b, scale))
    model, model_other = a.copy(), b.copy()
    mults_left = 2   # 3 data primes -> 2 rescales

    ops = ["add", "sub", "negate", "rotate", "conjugate", "multiply",
           "multiply_plain", "add_plain"]
    for step_i in range(10):
        op = ops[rng.integers(len(ops))]
        if op == "add":
            if ct_other.level != ct.level:
                break   # operand exhausted by earlier rescales
            ct = ev.add(ct, ct_other)
            model = model + model_other
        elif op == "sub":
            if ct_other.level != ct.level:
                break
            ct = ev.sub(ct, ct_other)
            model = model - model_other
        elif op == "negate":
            ct = ev.negate(ct)
            model = -model
        elif op == "rotate":
            s = int(rng.choice([-2, -1, 1, 2]))
            ct = ev.rotate_vector(ct, s, glk)
            model = np.roll(model, -s)
        elif op == "conjugate":
            ct = ev.complex_conjugate(ct, glk)
            model = np.conj(model)
        elif op == "multiply" and mults_left > 0:
            ct = ev.rescale_to_next(ev.relinearize(
                ev.multiply(ct, ct_other), rlk))
            model = model * model_other
            mults_left -= 1
            # re-encrypt the companion at the drifted scale/level so later
            # adds stay scale-exact (scale labels must track true scales)
            ct_other = enc.encrypt_symmetric(
                encd.encode(model_other, ct.scale, level=ct.level))
        elif op == "multiply_plain" and mults_left > 0:
            p = rng.uniform(-1, 1, HALF)
            pt = encd.encode(p, scale, level=ct.level)
            ct = ev.rescale_to_next(ev.multiply_plain(ct, pt))
            model = model * p
            mults_left -= 1
            ct_other = enc.encrypt_symmetric(
                encd.encode(model_other, ct.scale, level=ct.level))
        elif op == "add_plain":
            p = rng.uniform(-1, 1, HALF)
            pt = encd.encode(p, ct.scale, level=ct.level)
            ct = ev.add_plain(ct, pt)
            model = model + p
        got = encd.decode(dec.decrypt(ct))
        assert np.allclose(got, model, atol=1e-3), \
            f"ckks fuzz seed {fuzz_seed} diverged at step {step_i} ({op}): " \
            f"max err {np.abs(got - model).max()}"


def test_bfv_n4096_random_sequence():
    """Same fuzz at n=4096 over three 40-60-bit primes, where every NTT of
    the pipeline runs the butterfly network at a production width."""
    n = 4096
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [50, 40, 50])),
        plain_modulus=T.PlainModulus.batching(n, 18))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(4096))
    t = int(ctx.first_context_data.plain_modulus)
    rlk = kg.create_relin_keys()
    glk = kg.create_galois_keys(steps=[1, -1])
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    rng = np.random.default_rng(77)
    half = n // 2

    a = rng.integers(0, t, n, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    model = a.astype(object)
    mults_left = 1
    for step_i in range(6):
        op = ["add_plain", "multiply_plain", "square",
              "rotate_rows", "negate"][rng.integers(5)]
        p = rng.integers(0, t, n, dtype=np.uint64)
        if op == "add_plain":
            ct = ev.add_plain(ct, be.encode(p))
            model = (model + p.astype(object)) % t
        elif op == "multiply_plain":
            ct = ev.multiply_plain(ct, be.encode(p))
            model = (model * p.astype(object)) % t
        elif op == "square" and mults_left > 0:
            ct = ev.relinearize(ev.square(ct), rlk)
            model = (model * model) % t
            mults_left -= 1
        elif op == "rotate_rows":
            s = int(rng.choice([-1, 1]))
            ct = ev.rotate_rows(ct, s, glk)
            model = np.concatenate([np.roll(model[:half], -s),
                                    np.roll(model[half:], -s)])
        elif op == "negate":
            ct = ev.negate(ct)
            model = (-model) % t
        if dec.invariant_noise_budget(ct) <= 0:
            break
        got = be.decode(dec.decrypt(ct)).astype(object)
        assert np.array_equal(got, model % t), \
            f"n=4096 fuzz diverged at step {step_i} ({op})"
