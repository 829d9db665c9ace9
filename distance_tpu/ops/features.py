"""Bilinear decomposition of the per-site distance predicates.

This is the core idea of the engine.  Every integer counter that
the six measures consume is a sum over alignment sites of a 0/1 predicate
P(x_i, y_i) of the two Paradis codes.  Each predicate here is decomposed as

    P(x, y) = sum_k f_k(x) * g_k(y)

with per-code feature values f_k, g_k in {-1, 0, 1}.  Stacking the features
over sites turns the whole pairwise sweep into a GEMM:

    counter[s, t] = sum_i P(x_si, y_ti)
                  = sum_{i,k} F[s, i, k] * G[t, i, k]
                  = (F reshaped (n, L*r)) @ (G reshaped (n, L*r)).T

which runs on the tensor cores as an int8 x int8 -> int32 GEMM.  Features
are in {-1, 0, 1}, so int32 accumulation yields **exact** integers —
bit-for-bit parity with the reference's byte loop (its
src/measures.rs) by construction.

Counter decompositions (bA/bG/bC/bT = candidacy bits, kn = known bit,
eX = exact-base indicator = bX & kn, valid = code != 0):

* ``diff``  [(a & b) < 16, measures.rs:17]: candidacy sets disjoint.
  The 16-term inclusion-exclusion over subsets of {A,G,C,T} is rank
  deficient: nibble 15 (N, -, ?) intersects every candidacy set, so its
  row/column of the disjointness matrix is zero, and the matrix
  restricted to nibbles 1..14 is invertible — rank exactly 14.  The
  minimal factorization is the one-hot/table form
      [S cap T = empty] = sum_{n=1..14} [hi(x) = n] * [n & hi(y) = 0]
  with a ``valid`` gate on the y side so padded sites (code 0)
  contribute nothing — 14 channels, all features in {0, 1}.
* ``same``  [a == b && a & 8 == 8, measures.rs:60]: sum of eX(x) * eX(y)
  over the four bases — 4 channels.
* ``ts``    (k80 transitions, measures.rs:91-98): within a
  certainly-different pair, both-purine-set forces ({A},{G}) and
  both-pyrimidine-set forces ({C},{T}), so
      ts = eA@eG + eG@eA + eC@eT + eT@eC       — 4 channels.
* ``tv``    (k80 transversions, measures.rs:99-104): purine-set x
  pyrimidine-set pairs are automatically disjoint, so
      tv = pur@pyr + pyr@pur                    — 2 channels,
  with pur = valid & !bC & !bT, pyr = valid & !bA & !bG.
* ``kk``    (tn93 count_L, measures.rs:157-163): both bases exactly known:
      kk = kn@kn                                — 1 channel.
  (count_d = kk - same, since both-known sites are same xor diff.)
* ``p1``/``p2`` (tn93 transitions, measures.rs:167-173): the both-known
  gate reduces (a|b)==200 to {A,G} and (a|b)==56 to {C,T}:
      p1 = eA@eG + eG@eA,  p2 = eC@eT + eT@eC   — 2 channels each.

Each channel is specified as a (sign, primitive) pair, evaluated either
over ``np.arange(256)`` to produce host LUTs or symbolically over a device
array of codes (elementwise bit ops — no gathers on the hot path).  Both
evaluations share one definition, so they agree by construction.

Shared-channel plans (k80, tn93).  Each counter above is individually
rank-minimal (channels == rank of its 17x17 code-pair weight matrix), but
a measure's counters can SHARE rank-1 terms: with the +/- base pairings

    R = eA + eG,  R' = eA - eG,  Y = eC + eT,  Y' = eC - eT

the polarization identity  (u+w)@(u+w) + (u-w)@(u-w) = 2(u@u + w@w)
gives, writing O_F for the per-pair GEMM of channel F@F:

    2*same = O_R + O_R' + O_Y + O_Y'
    2*p1   = O_R - O_R'          2*p2 = O_Y - O_Y'
    2*ts   = O_R - O_R' + O_Y - O_Y'             (ts == p1 + p2)
    2*tv   = O_(pur+pyr) - O_(pur-pyr)
      kk   = O_kn

so k80 = {same, ts, tv} needs 6 channels instead of 4+4+2 = 10, and tn93
= {same, kk, p1, p2} needs 5 instead of 4+1+2+2 = 9.  Every factor still
takes values in {-1, 0, 1} (int8-exact) and every numerator is
even per site, so integer division by 2 after accumulation is exact —
including under site-sharding ("sp" psum).  These counts are optimal:

* k80: 6 == the rank of the horizontally stacked [W_same | W_ts | W_tv]
  (a lower bound on shared terms), met constructively above.
* tn93: restricted to the 4-dim exact-base space its slices are I (same),
  J (kk), and the two block swaps (p1, p2); J and a swap do not commute,
  so no 4-term simultaneous diagonalization exists — 5 is minimal.
* raw/jc69 (diff+same, 18 channels) provably cannot be improved by
  sharing: the pencil invariant M = U^+ W_same V^+ (U V^T a rank-14
  factorization of W_diff) is nilpotent with rank(M) = 4, M^2 = 0, i.e.
  four 2-Jordan blocks; by Ja'Ja's pencil-rank theorem the pair needs
  14 + 4 = 18 rank-1 terms — exactly what the per-counter plan uses.
* n/n_high use the single counter ``diff`` at its exact rank 14.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from distance_tpu.measures import MEASURE_COUNTERS

# A primitive is ("bits", candidacy_mask) — product of the selected
# candidacy bits (A=bit0 ... T=bit3 of the mask) — or one of the named
# forms below.  Channel = (sign, primitive).
Prim = Tuple[str, int]

_BIT_SHIFT = {0: 7, 1: 6, 2: 5, 3: 4}  # A, G, C, T candidacy bit positions


def eval_prim(prim: Prim, v, xp=np):
    """Evaluate a primitive over an array of uint8 codes -> int8 features.

    Works for numpy and jax.numpy alike (only >>, &, *, ==, astype used).
    """
    kind, arg = prim
    if kind == "bits":
        if arg == 0:
            # "valid": any candidacy bit set <=> code != 0 for real codes.
            out = (v != 0)
        else:
            out = None
            for b in range(4):
                if (arg >> b) & 1:
                    bit = (v >> _BIT_SHIFT[b]) & 1
                    out = bit if out is None else out * bit
    elif kind == "exact":
        # exact-base indicator: candidacy bit AND known bit
        out = ((v >> _BIT_SHIFT[arg]) & 1) * ((v >> 3) & 1)
    elif kind == "pur":
        out = (v != 0) * (1 - ((v >> 5) & 1)) * (1 - ((v >> 4) & 1))
    elif kind == "pyr":
        out = (v != 0) * (1 - ((v >> 7) & 1)) * (1 - ((v >> 6) & 1))
    elif kind == "known":
        out = (v >> 3) & 1
    elif kind == "hieq":
        # one-hot on the candidacy nibble: [hi(v) == arg]
        out = (v >> 4) == arg
    elif kind == "disj":
        # disjointness table row: [hi(v) & arg == 0], gated on valid
        out = (((v >> 4) & arg) == 0) * (v != 0)
    elif kind == "esum":
        # signed sum of two exact-base indicators: e_{b1} + s * e_{b2}
        b1, b2, s = arg
        out = eval_prim(("exact", b1), v, xp) + s * eval_prim(
            ("exact", b2), v, xp
        )
    elif kind == "ppsum":
        # purine-set +/- pyrimidine-set indicator (k80 tv polarization)
        out = eval_prim(("pur", 0), v, xp) + arg * eval_prim(
            ("pyr", 0), v, xp
        )
    else:
        raise ValueError(f"unknown primitive {kind!r}")
    if xp is np:
        return out.astype(np.int8)
    return out.astype("int8")


def _popcount4(m: int) -> int:
    return bin(m & 0xF).count("1")


# (sign_on_f_side, f_prim, g_prim) per channel, per counter.
Channel = Tuple[int, Prim, Prim]

_EA, _EG, _EC, _ET = ("exact", 0), ("exact", 1), ("exact", 2), ("exact", 3)

COUNTER_CHANNELS: Dict[str, List[Channel]] = {
    "diff": [
        (1, ("hieq", n), ("disj", n)) for n in range(1, 15)
    ],
    "same": [(1, _EA, _EA), (1, _EG, _EG), (1, _EC, _EC), (1, _ET, _ET)],
    "ts": [(1, _EA, _EG), (1, _EG, _EA), (1, _EC, _ET), (1, _ET, _EC)],
    "tv": [(1, ("pur", 0), ("pyr", 0)), (1, ("pyr", 0), ("pur", 0))],
    "kk": [(1, ("known", 0), ("known", 0))],
    "p1": [(1, _EA, _EG), (1, _EG, _EA)],
    "p2": [(1, _EC, _ET), (1, _ET, _EC)],
}

# Shared-channel plans (see module docstring): the measure's counters are
# integer mixes of a smaller shared channel set — counter_g =
# (sum_k num[g][k] * O_k) / den[g], with O_k the per-pair GEMM of channel
# k.  Factors stay in {-1, 0, 1}; every numerator is even per site.
_R, _RP = ("esum", (0, 1, 1)), ("esum", (0, 1, -1))
_Y, _YP = ("esum", (2, 3, 1)), ("esum", (2, 3, -1))
_SPP, _DPP = ("ppsum", 1), ("ppsum", -1)
_KN = ("known", 0)

SHARED_MEASURE_CHANNELS: Dict[str, Tuple[List[Channel], Dict[str, Tuple[Tuple[int, ...], int]]]] = {
    "k80": (
        [(1, _R, _R), (1, _RP, _RP), (1, _Y, _Y), (1, _YP, _YP),
         (1, _SPP, _SPP), (1, _DPP, _DPP)],
        {
            "same": ((1, 1, 1, 1, 0, 0), 2),
            "ts": ((1, -1, 1, -1, 0, 0), 2),
            "tv": ((0, 0, 0, 0, 1, -1), 2),
        },
    ),
    "tn93": (
        [(1, _KN, _KN), (1, _R, _R), (1, _RP, _RP), (1, _Y, _Y),
         (1, _YP, _YP)],
        {
            "same": ((0, 1, 1, 1, 1), 2),
            "kk": ((2, 0, 0, 0, 0), 2),
            "p1": ((0, 1, -1, 0, 0), 2),
            "p2": ((0, 0, 0, 1, -1), 2),
        },
    ),
}


def counter_luts(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(r, 256) int8 LUT pair (f_luts, g_luts) for one counter (its
    canonical per-counter decomposition, independent of plan sharing)."""
    return _luts_for(COUNTER_CHANNELS[name])


@dataclass(frozen=True, eq=False)  # id-hashable: plans are interned singletons
class CounterPlan:
    """Stacked feature channels for one measure's counter set.

    ``channels`` lists every (sign, f_prim, g_prim) in order.  For
    per-counter plans ``slices`` maps counter name -> (start, stop)
    channel range and ``mix_num``/``mix_den`` are None; for
    shared-channel plans ``slices`` is empty and counter g is
    ``(mix_num[g] . O) // mix_den[g]`` over the per-channel GEMMs O.
    ``f_luts``/``g_luts`` are the (R, 256) int8 host tables for the LUT
    path.
    """

    measure: str
    counters: Tuple[str, ...]
    channels: Tuple[Channel, ...]
    f_luts: np.ndarray
    g_luts: np.ndarray
    slices: Tuple[Tuple[str, int, int], ...]
    mix_num: Optional[np.ndarray] = None  # (G, R) int32
    mix_den: Optional[np.ndarray] = None  # (G,) int32

    @property
    def total_channels(self) -> int:
        return len(self.channels)

    @property
    def max_group_channels(self) -> int:
        """Largest channel count contracted into one accumulator — the
        f32-exactness bound is this times the alignment width."""
        if self.mix_num is not None:
            # per-channel GEMMs accumulate one channel each; the integer
            # mix afterwards scales the bound by the weight row sums
            return int(np.abs(self.mix_num).sum(axis=1).max())
        return max(hi - lo for _, lo, hi in self.slices)

    def slice_of(self, name: str) -> Tuple[int, int]:
        for n, lo, hi in self.slices:
            if n == name:
                return lo, hi
        raise KeyError(name)


_PLAN_CACHE: Dict[str, CounterPlan] = {}


def _luts_for(channels: List[Channel]) -> Tuple[np.ndarray, np.ndarray]:
    v = np.arange(256, dtype=np.uint8)
    f_rows, g_rows = [], []
    for sign, f_prim, g_prim in channels:
        f_rows.append(
            (sign * eval_prim(f_prim, v).astype(np.int16)).astype(np.int8)
        )
        g_rows.append(eval_prim(g_prim, v))
    return np.stack(f_rows), np.stack(g_rows)


def get_plan(measure: str) -> CounterPlan:
    if measure not in _PLAN_CACHE:
        import os

        counters = MEASURE_COUNTERS[measure]
        shared = SHARED_MEASURE_CHANNELS.get(measure)
        if shared is not None and not os.environ.get(
            "DISTANCE_TPU_NO_SHARED_PLAN"
        ):
            channels, mix = shared
            f_luts, g_luts = _luts_for(channels)
            _PLAN_CACHE[measure] = CounterPlan(
                measure=measure,
                counters=counters,
                channels=tuple(channels),
                f_luts=f_luts,
                g_luts=g_luts,
                slices=(),
                mix_num=np.array(
                    [mix[name][0] for name in counters], dtype=np.int32
                ),
                mix_den=np.array(
                    [mix[name][1] for name in counters], dtype=np.int32
                ),
            )
            return _PLAN_CACHE[measure]
        channels = []
        f_parts, g_parts = [], []
        slices = []
        pos = 0
        for name in counters:
            chans = COUNTER_CHANNELS[name]
            channels.extend(chans)
            f, g = counter_luts(name)
            f_parts.append(f)
            g_parts.append(g)
            slices.append((name, pos, pos + len(chans)))
            pos += len(chans)
        _PLAN_CACHE[measure] = CounterPlan(
            measure=measure,
            counters=counters,
            channels=tuple(channels),
            f_luts=np.concatenate(f_parts, axis=0),
            g_luts=np.concatenate(g_parts, axis=0),
            slices=tuple(slices),
        )
    return _PLAN_CACHE[measure]


def features_device(codes, plan: CounterPlan, side: str, xp, dtype):
    """Arithmetic (gather-free) feature build for device arrays.

    codes: (m, L) uint8 array (numpy or jax). Returns (R, m, L) ``dtype``.
    """
    feats = []
    for sign, f_prim, g_prim in plan.channels:
        prim = f_prim if side == "f" else g_prim
        feat = eval_prim(prim, codes, xp).astype(dtype)
        if side == "f" and sign < 0:
            feat = -feat
        feats.append(feat)
    return xp.stack(feats)


def reference_counter_matrix(name: str) -> np.ndarray:
    """(256, 256) predicate truth table implied by the decomposition —
    used by tests to verify against the measures.rs byte predicates."""
    f, g = counter_luts(name)
    return (f.astype(np.int32).T @ g.astype(np.int32)).astype(np.int32)
