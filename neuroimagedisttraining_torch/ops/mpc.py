"""Finite-field MPC primitives for secure aggregation (TurboAggregate):
this package's own copy of ``neuroimagedisttraining_tpu/ops/mpc.py``.

The reference module imports only numpy; the port keeps a copy so that it
imports nothing of the JAX package. Modular inverse, Lagrange
coefficients, BGW (Shamir) secret sharing, Lagrange Coded Computing
encode and decode, additive secret shares, DH-style key agreement and the
fixed-point transport, as host numpy int64 field arithmetic (exact for
primes p with p^2 < 2^63), bit for bit the reference's on the same inputs
and the same ``np.random.RandomState`` (tests/test_torch_port_turboaggregate.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_PRIME = 2_147_483_647  # 2^31 - 1 (Mersenne)


def mod_inverse(a: int, p: int) -> int:
    """Modular inverse via Fermat's little theorem (p prime)."""
    a = int(a) % p
    if a == 0:
        raise ZeroDivisionError("no inverse for 0")
    return pow(a, p - 2, p)


def field_div(num, den, p: int):
    """Elementwise num/den in F_p."""
    inv = mod_inverse(int(den), p)
    return np.mod(np.asarray(num, np.int64) * np.int64(inv), p)


def _matmul_mod(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """``(a @ b) mod p`` without int64 overflow: a plain matmul accumulates
    up to K products of size (p-1)^2 each before reducing, which wraps for
    K >= 3 at p ~ 2^31; reducing after every rank-1 term keeps every partial
    below p^2 + p < 2^63."""
    a = np.mod(np.asarray(a, np.int64), p)
    b = np.mod(np.asarray(b, np.int64), p)
    out = np.zeros((a.shape[0],) + b.shape[1:], np.int64)
    for j in range(a.shape[1]):
        out = np.mod(out + a[:, j, None] * b[j], p)
    return out


def lagrange_coeffs(
    targets: Sequence[int], nodes: Sequence[int], p: int
) -> np.ndarray:
    """L[i, j] = ell_j(targets[i]) over F_p for interpolation nodes
    ``nodes`` — the coefficient matrix for evaluating the interpolating
    polynomial at ``targets``."""
    targets = [int(t) % p for t in targets]
    nodes = [int(b) % p for b in nodes]
    m, n = len(targets), len(nodes)
    out = np.zeros((m, n), dtype=np.int64)
    for j, bj in enumerate(nodes):
        den = 1
        for k, bk in enumerate(nodes):
            if k != j:
                den = den * ((bj - bk) % p) % p
        inv_den = mod_inverse(den, p)
        for i, t in enumerate(targets):
            num = 1
            for k, bk in enumerate(nodes):
                if k != j:
                    num = num * ((t - bk) % p) % p
            out[i, j] = num * inv_den % p
    return out


def _poly_eval(coeffs: np.ndarray, x: int, p: int) -> np.ndarray:
    """Horner evaluation of a coefficient stack [T+1, ...] at scalar x."""
    acc = np.zeros_like(coeffs[0])
    for c in coeffs[::-1]:
        acc = np.mod(acc * np.int64(x) + c, p)
    return acc


def shamir_share(
    x: np.ndarray, n_shares: int, threshold: int, p: int,
    rng: np.random.RandomState = None,
) -> np.ndarray:
    """BGW/Shamir sharing: degree-``threshold`` polynomial with constant
    term x, evaluated at alpha = 1..n (mpc_function.py BGW_encoding).
    Returns [n_shares, *x.shape]."""
    rng = rng or np.random.RandomState()
    x = np.mod(np.asarray(x, np.int64), p)
    coeffs = np.concatenate([
        x[None], rng.randint(0, p, size=(threshold,) + x.shape),
    ]).astype(np.int64)
    return np.stack([
        _poly_eval(coeffs, alpha, p) for alpha in range(1, n_shares + 1)
    ])


def shamir_reconstruct(
    shares: np.ndarray, holder_idx: Sequence[int], p: int
) -> np.ndarray:
    """Reconstruct the secret (evaluation at 0) from >= threshold+1 shares
    held by alpha indices ``holder_idx`` (0-based; alpha = idx+1)
    (mpc_function.py BGW_decoding)."""
    alphas = [i + 1 for i in holder_idx]
    lam = lagrange_coeffs([0], alphas, p)[0]  # [len(shares)]
    acc = np.zeros_like(np.asarray(shares[0], np.int64))
    for l, s in zip(lam, shares):
        acc = np.mod(acc + np.int64(l) * np.asarray(s, np.int64), p)
    return acc


def lcc_encode(
    x: np.ndarray, n_workers: int, k_split: int, t_privacy: int, p: int,
    rng: np.random.RandomState = None,
) -> np.ndarray:
    """Lagrange Coded Computing encode (mpc_function.py LCC_encoding):
    split x's leading axis into K chunks, append T random chunks, pass the
    interpolating polynomial through them at beta nodes, and evaluate at
    alpha nodes for the N workers. Returns [N, len//K, ...]."""
    rng = rng or np.random.RandomState()
    m = x.shape[0]
    if m % k_split:
        # an explicit raise, not an assert: python -O must not strip the
        # shape contract of the secure-sum encoding
        raise ValueError(
            f"LCC encoding needs the leading axis ({m}) to divide "
            f"into K={k_split} chunks")
    chunk = m // k_split
    subs = [np.mod(np.asarray(x[i * chunk:(i + 1) * chunk], np.int64), p)
            for i in range(k_split)]
    subs += [rng.randint(0, p, size=subs[0].shape).astype(np.int64)
             for _ in range(t_privacy)]
    betas = list(range(1, k_split + t_privacy + 1))
    alphas = list(range(k_split + t_privacy + 1,
                        k_split + t_privacy + 1 + n_workers))
    lam = lagrange_coeffs(alphas, betas, p)  # [N, K+T]
    stacked = np.stack(subs)  # [K+T, chunk, ...]
    flat = stacked.reshape(len(subs), -1)
    enc = _matmul_mod(lam, flat, p)
    return enc.reshape((n_workers,) + stacked.shape[1:])


def lcc_decode(
    worker_outputs: np.ndarray, worker_ids: Sequence[int],
    n_workers: int, k_split: int, t_privacy: int, p: int,
) -> np.ndarray:
    """LCC decode (mpc_function.py LCC_decoding): interpolate worker
    evaluations back to the beta nodes of the data chunks, for degree-1
    (identity / secure-aggregation) computations — the encoding polynomial
    has degree K+T-1, so at least K+T worker outputs are required.
    Returns [K, chunk, ...]."""
    if len(worker_ids) < k_split + t_privacy:
        raise ValueError(
            f"need >= K+T = {k_split + t_privacy} worker outputs to decode, "
            f"got {len(worker_ids)}"
        )
    betas = list(range(1, k_split + t_privacy + 1))
    alphas = list(range(k_split + t_privacy + 1,
                        k_split + t_privacy + 1 + n_workers))
    eval_points = [alphas[i] for i in worker_ids]
    lam = lagrange_coeffs(betas[:k_split], eval_points, p)  # [K, n_used]
    flat = np.mod(np.asarray(worker_outputs, np.int64).reshape(len(worker_ids), -1), p)
    dec = _matmul_mod(lam, flat, p)
    return dec.reshape((k_split,) + worker_outputs.shape[1:])


def additive_shares(
    x: np.ndarray, n_shares: int, p: int,
    rng: np.random.RandomState = None,
) -> np.ndarray:
    """Additive secret sharing (mpc_function.py Gen_Additive_SS): n-1
    uniform shares plus a correction share summing to x mod p."""
    rng = rng or np.random.RandomState()
    x = np.mod(np.asarray(x, np.int64), p)
    shares = rng.randint(0, p, size=(n_shares - 1,) + x.shape).astype(np.int64)
    last = np.mod(x - shares.sum(axis=0), p)
    return np.concatenate([shares, last[None]])


def dh_keygen(sk: int, g: int, p: int) -> int:
    """Public key g^sk mod p (mpc_function.py my_pk_gen)."""
    return pow(int(g), int(sk), int(p))


def dh_key_agreement(their_pk: int, my_sk: int, p: int) -> int:
    """Shared key pk^sk mod p (mpc_function.py my_key_agreement)."""
    return pow(int(their_pk), int(my_sk), int(p))


# ---------------------------------------------------------------------------
# fixed-point quantization for model <-> field transport
# ---------------------------------------------------------------------------

def quantize(x: np.ndarray, scale: int, p: int) -> np.ndarray:
    """Map floats to F_p with fixed-point scale; negatives wrap mod p."""
    q = np.round(np.asarray(x, np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize(q: np.ndarray, scale: int, p: int) -> np.ndarray:
    """Inverse of ``quantize``: values above p/2 are negative."""
    q = np.asarray(q, np.int64)
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale
