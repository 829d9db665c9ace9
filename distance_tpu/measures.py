"""Reference-semantics distance measures (host oracle).

Vectorized NumPy implementations of the six measures with semantics matching
/root/reference/src/measures.rs exactly.  These serve as the golden oracle
for the device GEMMs and as the compute path for tiny inputs; the production
path computes the same integer counters on the device (see ops/) and finalizes
with the identical f64 expressions below.

Every finalization uses ``math.log`` / ``math.sqrt`` (glibc libm — the same
functions Rust's ``f64::ln``/``sqrt`` lower to on linux-gnu), replaying the
reference's exact f64 expression shapes so results are bit-for-bit equal.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import numpy as np

FloatInt = Union[int, float]

MEASURES = ("n", "n_high", "raw", "jc69", "k80", "tn93")

# Which integer counters each measure consumes (see ops/features.py for the
# bilinear decompositions that compute them as GEMMs).
MEASURE_COUNTERS: Dict[str, Tuple[str, ...]] = {
    "n": ("diff",),
    "n_high": ("diff",),
    "raw": ("diff", "same"),
    "jc69": ("diff", "same"),
    "k80": ("same", "ts", "tv"),
    "tn93": ("same", "kk", "p1", "p2"),
}


# ---------------------------------------------------------------------------
# Site-level counters (the exact predicates from measures.rs)
# ---------------------------------------------------------------------------

def pair_counters(q: np.ndarray, t: np.ndarray) -> Dict[str, int]:
    """All integer counters for one encoded pair (site predicates from
    /root/reference/src/measures.rs:14-175)."""
    qi = q.astype(np.int32)
    ti = t.astype(np.int32)
    diff = (qi & ti) < 16                      # certainly different
    same = (qi == ti) & ((qi & 8) == 8)        # certainly same
    pur_q = (qi & 55) == 0                     # candidacy subset of {A,G}
    pur_t = (ti & 55) == 0
    pyr_q = (qi & 199) == 0                    # candidacy subset of {C,T}
    pyr_t = (ti & 199) == 0
    known = ((qi & 8) == 8) & ((ti & 8) == 8)
    ts = diff & ((pur_q & pur_t) | (pyr_q & pyr_t))
    tv = diff & ((pur_q & pyr_t) | (pyr_q & pur_t))
    d_known = diff & known
    p1 = d_known & ((qi | ti) == 200)          # A <-> G
    p2 = d_known & ((qi | ti) == 56)           # C <-> T
    return {
        "diff": int(np.count_nonzero(diff)),
        "same": int(np.count_nonzero(same)),
        "ts": int(np.count_nonzero(ts)),
        "tv": int(np.count_nonzero(tv)),
        # Both-known sites are always either certainly-same or
        # certainly-different, so tn93's count_L is just the known count.
        "kk": int(np.count_nonzero(known)),
        "p1": int(np.count_nonzero(p1)),
        "p2": int(np.count_nonzero(p2)),
    }


# ---------------------------------------------------------------------------
# Per-pair measures (oracle entry points)
# ---------------------------------------------------------------------------

def snp(q: np.ndarray, t: np.ndarray) -> int:
    """-m n / -m n_high: count of certainly-different sites
    (/root/reference/src/measures.rs:14-23).  The reference's sparse
    ``snp_consensus`` variant (measures.rs:28-53) returns the same value
    by construction; its sparsification is generalized here as the
    engine's exact invariant-column pruning
    (engine._prune_invariant_columns), which benefits all six measures.
    """
    return int(np.count_nonzero((q.astype(np.int32) & t.astype(np.int32)) < 16))


def _raw_from_counts(n_diff: int, denom: int) -> float:
    # /root/reference/src/measures.rs:56-69: denominator = certainly-same
    # + certainly-different sites; 0/0 => NaN.
    return _div(float(n_diff), float(denom))


def _div(a: float, b: float) -> float:
    if b == 0.0:
        if a == 0.0:
            return math.nan
        return math.inf if a > 0 else -math.inf
    return a / b


def raw(q: np.ndarray, t: np.ndarray) -> float:
    c = pair_counters(q, t)
    return _raw_from_counts(c["diff"], c["same"] + c["diff"])


def jc69(q: np.ndarray, t: np.ndarray) -> float:
    c = pair_counters(q, t)
    return finalize_jc69(c["diff"], c["same"] + c["diff"])


def k80(q: np.ndarray, t: np.ndarray) -> float:
    c = pair_counters(q, t)
    return finalize_k80(c["same"], c["ts"], c["tv"])


def tn93(
    q: np.ndarray,
    t: np.ndarray,
    q_counts: Tuple[int, int, int, int],
    t_counts: Tuple[int, int, int, int],
) -> float:
    """q_counts/t_counts are (A, T, G, C) tallies — loaded path counts
    encoded codes, streamed path counts raw upper-case chars (reference
    inconsistency reproduced at the I/O layer)."""
    c = pair_counters(q, t)
    return finalize_tn93(
        c["same"], c["kk"], c["p1"], c["p2"], q_counts, t_counts
    )


# ---------------------------------------------------------------------------
# f64 finalization (shared by oracle and device counter path)
# ---------------------------------------------------------------------------

def _ln(x: float) -> float:
    """f64 ln with Rust semantics: ln(negative) = NaN, ln(0) = -inf."""
    if x > 0.0:
        return math.log(x)
    if x == 0.0:
        return -math.inf
    return math.nan


def _sqrt(x: float) -> float:
    """f64 sqrt with Rust semantics: sqrt(negative) = NaN."""
    if x >= 0.0:
        return math.sqrt(x)
    return math.nan


def finalize_raw(n_diff: int, denom: int) -> float:
    return _raw_from_counts(n_diff, denom)


def finalize_jc69(n_diff: int, denom: int) -> float:
    # /root/reference/src/measures.rs:72-77
    p = _raw_from_counts(n_diff, denom)
    return -0.75 * _ln(1.0 - (4.0 / 3.0) * p)


def finalize_k80(same: int, ts: int, tv: int) -> float:
    # /root/reference/src/measures.rs:80-113; count_L drops
    # certainly-different-but-unclassifiable sites.
    count_l = same + ts + tv
    p = _div(float(ts), float(count_l))
    q = _div(float(tv), float(count_l))
    return -0.5 * _ln((1.0 - 2.0 * p - q) * _sqrt(1.0 - 2.0 * q))


def finalize_tn93(
    same: int,
    kk: int,
    p1_count: int,
    p2_count: int,
    q_counts: Tuple[int, int, int, int],
    t_counts: Tuple[int, int, int, int],
) -> float:
    # /root/reference/src/measures.rs:116-193.  kk = both-bases-known sites
    # (= count_L there); count_d = kk - same.
    qa, qt, qg, qc = (int(v) for v in q_counts)
    ta, tt, tg, tc = (int(v) for v in t_counts)
    big_l = qa + qt + qg + qc + ta + tt + tg + tc

    g_a = _div(float(ta) + float(qa), float(big_l))
    g_c = _div(float(tc) + float(qc), float(big_l))
    g_g = _div(float(tg) + float(qg), float(big_l))
    g_t = _div(float(tt) + float(qt), float(big_l))
    g_r = _div(float(ta) + float(qa) + float(tg) + float(qg), float(big_l))
    g_y = _div(float(tc) + float(qc) + float(tt) + float(qt), float(big_l))

    k1 = _div(2.0 * g_a * g_g, g_r)
    k2 = _div(2.0 * g_t * g_c, g_y)
    k3 = 2.0 * (
        g_r * g_y - _div(g_a * g_g * g_y, g_r) - _div(g_t * g_c * g_r, g_y)
    )

    count_l = kk
    count_d = kk - same
    p1 = _div(float(p1_count), float(count_l))
    p2 = _div(float(p2_count), float(count_l))
    q_rate = _div(float(count_d - (p1_count + p2_count)), float(count_l))

    w1 = 1.0 - _div(p1, k1) - _div(q_rate, 2.0 * g_r)
    w2 = 1.0 - _div(p2, k2) - _div(q_rate, 2.0 * g_y)
    w3 = 1.0 - _div(q_rate, 2.0 * g_r * g_y)

    d = -k1 * _ln(w1) - k2 * _ln(w2) - k3 * _ln(w3)
    if d == 0.0:
        d = 0.0  # normalizes -0.0 (measures.rs:188-190)
    return d
