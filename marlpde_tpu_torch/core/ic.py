"""Initial conditions needed by the ported slice.

Copied from marlpde_tpu/core/ic.py:24-110 (numpy only; the port may not import
the JAX package): the turbulence IC's LCG (a=1103515245, c=12345, m=2^13) in
closed form, and the host float64 turbulence IC (Burger.py:227-259) that the
DNS pool build uses.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

LCG_A = 1103515245
LCG_C = 12345
LCG_M = 2**13


@lru_cache(maxsize=32)
def _lcg_closed_form(nk: int):
    """Precompute (a^k mod m, c*sum_{j<k} a^j mod m) for k = 1..nk as numpy arrays."""
    ak = np.zeros(nk, dtype=np.int64)
    ck = np.zeros(nk, dtype=np.int64)
    # state after (i+1) LCG applications: rng_{i+1} = a^{i+1}*rng0 + c*(a^i + ... + 1)
    a_pow, c_sum = 1, 0
    for i in range(nk):
        a_pow = (a_pow * LCG_A) % LCG_M
        c_sum = (c_sum * LCG_A + LCG_C) % LCG_M
        ak[i] = a_pow
        ck[i] = c_sum
    return ak, ck


def burger_turbulence_numpy(tseed, offset, x, L):
    """Host float64 version of the turbulence IC (bit-parity with the LCG loop)."""
    x = np.asarray(x, np.float64)
    N = x.shape[-1]
    rng = 123456789 + int(tseed)
    u0 = np.ones(N)
    for k in range(1, N):
        rng = (LCG_A * rng + LCG_C) % LCG_M
        phase = rng / LCG_M * 2.0 * np.pi
        Ek = 5.0 ** (-5.0 / 3.0) if k <= 5 else k ** (-5.0 / 3.0)
        u0 += np.sqrt(2 * Ek) * np.sin(k * 2 * np.pi * (x + offset) / L + phase)
    idx = 0
    criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
    while criterion < 0.65 or criterion > 0.75:
        u0 *= 0.7 / criterion
        criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
        idx += 1
        if idx > 100:
            break
    return u0
