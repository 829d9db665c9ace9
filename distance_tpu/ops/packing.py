"""Device-side counter packing to minimize device->host traffic.

Counters are bounded by the alignment width L, so for L < 2^16 every
counter fits in 16 bits and a measure's counter set packs into one or two
32-bit lanes per pair ("wide" packing):

    n, n_high : [diff]                    -> 16-bit         (2 B/pair)
    raw, jc69 : [diff<<16 | same]         -> 1 x 32-bit     (4 B/pair)
    k80       : [same<<16 | ts, tv]       -> 2 x 32-bit     (8 B/pair)
    tn93      : [same<<16 | kk, p1<<16|p2]-> 2 x 32-bit     (8 B/pair)

On top of that, real alignments are low-diversity: per-pair difference
counts are tiny and agreement counts are close to L.  "Narrow" packing
exploits this with saturating 8-bit lanes (value 255 = saturated):

    n, n_high : [diff]                          1 B/pair
    raw, jc69 : [diff, L - (same+diff)]         2 B/pair
    k80       : [L - count_L, ts, tv]           3 B/pair
    tn93      : [L - kk, kk - same, p1, p2]     4 B/pair

The host detects any 255 lane and falls back to a wide refetch of that
strip — exactness is never compromised, narrow packing is purely a
transfer-size optimization (2-4x on top of wide).

Packing happens in-graph on device (jnp); unpacking is vectorized NumPy
on host.  Packed words travel as SIGNED ints and are viewed back as
unsigned on the host.  For L >= 2^16 the engine transfers raw int32
counters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

PACK_LIMIT = 1 << 16  # alignment width must be < 2^16 to pack (wide)
NARROW_SAT = 255


def _bitcast(a, dtype, xp):
    if xp is np:
        return np.ascontiguousarray(a).view(dtype)
    import jax

    return jax.lax.bitcast_convert_type(a, dtype)


def pack_device(measure: str, counters, xp):
    """(G, m, n) int32 array (numpy or jax) -> packed array (P, m, n).

    Returns int16 for the single-counter measures, int32 otherwise — the
    packed words are bit patterns, signed on the wire; unpack_host views
    them back as unsigned.
    """
    c = counters
    if measure in ("n", "n_high"):
        return _bitcast(c[0].astype(xp.uint16), xp.int16, xp)[None]
    if measure in ("raw", "jc69"):
        w0 = (c[0].astype(xp.uint32) << 16) | c[1].astype(xp.uint32)
        return _bitcast(w0, xp.int32, xp)[None]
    if measure == "k80":
        w0 = (c[0].astype(xp.uint32) << 16) | c[1].astype(xp.uint32)
        return xp.stack([_bitcast(w0, xp.int32, xp), c[2]])
    if measure == "tn93":
        w0 = (c[0].astype(xp.uint32) << 16) | c[1].astype(xp.uint32)
        w1 = (c[2].astype(xp.uint32) << 16) | c[3].astype(xp.uint32)
        return xp.stack(
            [_bitcast(w0, xp.int32, xp), _bitcast(w1, xp.int32, xp)]
        )
    raise ValueError(measure)


def unpack_host(measure: str, packed: np.ndarray) -> np.ndarray:
    """Packed host array -> (G, ...) int32 counters (same order as the
    measure's CounterPlan)."""
    if measure in ("n", "n_high"):
        return packed.view(np.uint16).astype(np.int32)
    p = packed.view(np.uint32)
    hi0 = (p[0] >> 16).astype(np.int32)
    lo0 = (p[0] & 0xFFFF).astype(np.int32)
    if measure in ("raw", "jc69"):
        return np.stack([hi0, lo0])
    if measure == "k80":
        return np.stack([hi0, lo0, p[1].astype(np.int32)])
    if measure == "tn93":
        hi1 = (p[1] >> 16).astype(np.int32)
        lo1 = (p[1] & 0xFFFF).astype(np.int32)
        return np.stack([hi0, lo0, hi1, lo1])
    raise ValueError(measure)


# ---------------------------------------------------------------------------
# Narrow (saturating 8-bit) packing
# ---------------------------------------------------------------------------

def pack_device_narrow(measure: str, counters, width: int, xp):
    """(G, m, n) int32 counters -> (P, m, n) int8 saturating lanes."""
    c = counters

    def sat(v):
        return _bitcast(
            xp.minimum(v, NARROW_SAT).astype(xp.uint8), xp.int8, xp
        )

    if measure in ("n", "n_high"):
        lanes = [sat(c[0])]
    elif measure in ("raw", "jc69"):
        lanes = [sat(c[0]), sat(width - (c[0] + c[1]))]
    elif measure == "k80":
        lanes = [sat(width - (c[0] + c[1] + c[2])), sat(c[1]), sat(c[2])]
    elif measure == "tn93":
        lanes = [sat(width - c[1]), sat(c[1] - c[0]), sat(c[2]), sat(c[3])]
    else:
        raise ValueError(measure)
    return xp.stack(lanes)


# ---------------------------------------------------------------------------
# Relative (rank-1 baseline) packing
# ---------------------------------------------------------------------------
#
# Every counter is a sum over columns of f(x_col, y_col), so for any
# reference row `ref`:
#
#     c(i, r) - c(i, ref) - c(ref, r) + c(ref, ref)
#
# accrues ONLY on columns where BOTH x_i and y_r differ from ref — the
# overlap of two records' divergences, typically a handful of columns
# even for very diverse data (E[overlap] = d_i * d_r / L).  The residual
# therefore fits int8 regardless of diversity; shipping int8 residual
# lanes plus the tiny per-row/per-column baseline vectors costs 1 byte
# per counter per pair — the narrow-pack wire size without its
# low-diversity assumption.

REL_SAT = -128  # sentinel: residual out of [-127, 127] (wide refetch)
REL4_SAT = -8   # nibble sentinel: residual out of [-7, 7]


def pack_device_rel(c, rb, cb, cc, xp, mask=None):
    """(G, m, n) int32 counters -> (G, m, n) int8 residual lanes.

    ``rb``: (G, m) counters vs the reference row (c(i, ref));
    ``cb``: (G, n) reference-vs-batch counters (c(ref, r));
    ``cc``: (G,) the reference self-counter (c(ref, ref)).
    ``mask``: optional (m, n) bool of cells to exclude from the
    saturation check (their lanes are zeroed).  Square sweeps pass the
    self-pair diagonal: c(i, i) has residual -2*c(i, ref), which would
    saturate for any record >63 counts from the reference even though
    self-pairs are never emitted.
    """
    res = c - rb[:, :, None] - cb[:, None, :] + cc[:, None, None]
    if mask is not None:
        res = xp.where(mask[None, :, :], 0, res)
    sat = xp.abs(res) > 127
    return xp.where(sat, REL_SAT, res).astype(xp.int8)


def unpack_host_rel(
    packed: np.ndarray, rb: np.ndarray, cb: np.ndarray, cc: np.ndarray
) -> Optional[np.ndarray]:
    """Residual lanes + baselines -> (G, m, n) int32 counters, or None
    if any lane saturated (caller must refetch wide).

    The saturation scan runs BEFORE the int32 widening: a saturated
    strip (the case this function exists to detect) must not pay a
    4x-size allocation it immediately discards."""
    if (packed == REL_SAT).any():
        return None
    a = packed.astype(np.int32)
    return a + rb[:, :, None] + cb[:, None, :] - cc[:, None, None]


# Exception sidecar: outliers beyond the nibble range ship as (flat
# index, value) pairs instead of forcing a whole-strip wide refetch.
# Extraction must stay cheap in-graph (a full nonzero/sort over the
# residual tensor measured 4.7x the sweep's device time), so it is
# segmented: the flat tensor splits into REL4_SEGMENTS ranges and two
# argmax reductions recover the FIRST and LAST outlier per segment.
# Residual tails are Poisson-thin (mean overlap d_i*d_r/L): with ~100
# outliers among millions of cells, a segment holding >= 3 is vanishing
# — and when it happens those cells simply stay -8 and the strip takes
# the existing wide refetch.  Sidecar = 2 * REL4_SEGMENTS entries.
REL4_SEGMENTS = 8192
REL4_EXC_CAP = 2 * REL4_SEGMENTS


def pack_device_rel4(c, rb, cb, cc, xp, mask=None):
    """Rank-1 residuals packed two per byte: (G, m, n) int32 counters ->
    (lanes (G, m, n/2) int8, exc_idx (CAP,) int32, exc_val (CAP,) int32).

    Same baseline correction as pack_device_rel at HALF the wire bytes;
    residuals in [-7, 7], -8 = out-of-range sentinel whose true value
    travels in the exception sidecar (flat indices into the (G, m, n)
    residual tensor; unused slots hold index -1).  The column axis must
    be even (device blocks are tile-padded).
    """
    res = c - rb[:, :, None] - cb[:, None, :] + cc[:, None, None]
    if mask is not None:
        res = xp.where(mask[None, :, :], 0, res)
    sat = xp.abs(res) > 7
    nib = xp.where(sat, REL4_SAT, res) & 0xF  # two's-complement nibble
    u = nib.astype(xp.uint8)
    byte = u[..., 0::2] | (u[..., 1::2] << 4)
    lanes = _bitcast(byte, xp.int8, xp)

    n_flat = int(np.prod(res.shape))
    seg_len = -(-n_flat // REL4_SEGMENTS)
    pad = REL4_SEGMENTS * seg_len - n_flat
    flat_sat = xp.concatenate(
        [sat.reshape(-1), xp.zeros(pad, dtype=sat.dtype)]
    ).reshape(REL4_SEGMENTS, seg_len)
    flat_res = res.reshape(-1)
    count = flat_sat.sum(axis=1)
    first = xp.argmax(flat_sat, axis=1)
    last = seg_len - 1 - xp.argmax(flat_sat[:, ::-1], axis=1)
    base = xp.arange(REL4_SEGMENTS, dtype=xp.int32) * np.int32(seg_len)
    idx1 = xp.where(count >= 1, base + first.astype(xp.int32), -1)
    idx2 = xp.where(count >= 2, base + last.astype(xp.int32), -1)
    exc_idx = xp.concatenate([idx1, idx2]).astype(xp.int32)
    safe = xp.clip(exc_idx, 0, n_flat - 1)
    exc_val = xp.where(exc_idx >= 0, flat_res[safe], 0).astype(xp.int32)
    return lanes, exc_idx, exc_val


def unpack_rel4_nibbles(packed: np.ndarray) -> np.ndarray:
    """(..., n/2) int8 packed bytes -> (..., n) int32 residuals
    (sign-extended; REL4_SAT marks saturation — caller checks after
    cropping away padding columns)."""
    b = packed.view(np.uint8)
    nib = np.empty(b.shape[:-1] + (b.shape[-1] * 2,), dtype=np.uint8)
    nib[..., 0::2] = b & 0xF
    nib[..., 1::2] = b >> 4
    val = nib.astype(np.int32)
    val -= (val > 7) * 16
    return val


def finish_host_rel4(
    res: np.ndarray,
    rb: np.ndarray,
    cb: np.ndarray,
    cc: np.ndarray,
    bad: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Cropped int32 nibble residuals + baselines -> counters, or None
    on saturation.  ``bad`` marks cells whose -8 is an UNPATCHED
    sentinel (callers that patched the exception sidecar clear patched
    positions first — a patched value may legitimately be -8); without
    it any -8 counts as saturation."""
    if bad is None:
        bad = res == REL4_SAT
    if bad.any():
        return None
    return res + rb[:, :, None] + cb[:, None, :] - cc[:, None, None]


# ---------------------------------------------------------------------------
# Sidecar bundling: one D2H request for all small rel-family arrays
# ---------------------------------------------------------------------------
#
# A rel-packed fetch moves one large lanes tensor plus several small
# int32 arrays (column baselines, row baselines + self-counter, and the
# rel4 exception sidecar).  High-latency transports charge per REQUEST,
# so the small arrays are fused device-side into a single self-
# describing 1-D int32 "bundle" and split again on host.

SIDECAR_MAGIC = 0x52454C42  # 'RELB'
_HDR = 6  # [magic, G, ti, span, exc_b, cap]


def bundle_sidecars(xp, cb, rb_cc, exc_idx=None, exc_val=None):
    """Fuse the small rel-family arrays into one 1-D int32 vector.

    ``cb``: (G, span) column baselines; ``rb_cc``: (G, ti+1) row
    baselines + self-counter; optional rel4 exception sidecar
    ``exc_idx``/``exc_val``: (CAP,) or (B, CAP) block-stacked.  A
    (CAP,) sidecar is recorded as B=1 — block-local index math with one
    block spanning all columns is the identity mapping.
    """
    g, span = cb.shape
    ti = rb_cc.shape[1] - 1
    if exc_idx is None:
        exc_b = cap = 0
        tail = []
    else:
        exc_b = 1 if exc_idx.ndim == 1 else int(exc_idx.shape[0])
        cap = int(exc_idx.shape[-1])
        tail = [exc_idx.reshape(-1), exc_val.reshape(-1)]
    header = xp.asarray(
        np.array([SIDECAR_MAGIC, g, ti, span, exc_b, cap], dtype=np.int32)
    )
    return xp.concatenate(
        [header, cb.reshape(-1), rb_cc.reshape(-1), *tail]
    ).astype(xp.int32)


def unbundle_sidecars(flat: np.ndarray):
    """Split a fetched bundle back into (cb, rb_cc, exc_idx, exc_val);
    the exception entries are None for plain rel."""
    h = flat[:_HDR]
    if int(h[0]) != SIDECAR_MAGIC:
        raise ValueError("not a sidecar bundle")
    g, ti, span, exc_b, cap = (int(v) for v in h[1:])
    o = _HDR
    cb = flat[o : o + g * span].reshape(g, span)
    o += g * span
    rb_cc = flat[o : o + g * (ti + 1)].reshape(g, ti + 1)
    o += g * (ti + 1)
    if not exc_b:
        return cb, rb_cc, None, None
    exc_idx = flat[o : o + exc_b * cap].reshape(exc_b, cap)
    o += exc_b * cap
    exc_val = flat[o : o + exc_b * cap].reshape(exc_b, cap)
    return cb, rb_cc, exc_idx, exc_val


def unpack_host_narrow(
    measure: str, packed: np.ndarray, width: int
) -> Optional[np.ndarray]:
    """Narrow lanes -> (G, ...) int32 counters, or None if any lane
    saturated (caller must refetch wide)."""
    a = packed.view(np.uint8)
    if (a == NARROW_SAT).any():
        return None
    a = a.astype(np.int32)
    if measure in ("n", "n_high"):
        return a
    if measure in ("raw", "jc69"):
        diff = a[0]
        same = (width - a[1]) - diff
        return np.stack([diff, same])
    if measure == "k80":
        count_l = width - a[0]
        same = count_l - a[1] - a[2]
        return np.stack([same, a[1], a[2]])
    if measure == "tn93":
        kk = width - a[0]
        same = kk - a[1]
        return np.stack([same, kk, a[2], a[3]])
    raise ValueError(measure)
