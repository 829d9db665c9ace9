"""Exact f64 finalization of device counters into distances.

The device GEMMs produce exact integer counters per pair; this module
replays the reference's f64 closed forms (/root/reference/src/measures.rs)
over those counters.  The native path (C, glibc libm) is used when
available; the Python fallback calls ``math.log`` per element (also glibc).
Both are bit-for-bit identical to the Rust binary's arithmetic.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from distance_tpu import measures
from distance_tpu._native import get_lib

INT_MEASURES = ("n", "n_high")

# tn93's extra per-pair inputs: the two sequences' (A,T,G,C) tallies,
# supplied as per-sequence tables + per-pair row indices.  The native
# finalizer gathers the rows itself (8 int32 loads/pair) — the engine
# never materializes per-pair tally arrays.
BasePairRef = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def finalize_block(
    measure: str,
    counters: Dict[str, np.ndarray],
    bc: Optional[BasePairRef] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Finalize a flat block of pairs.

    Args:
      measure: one of the six measure names.
      counters: counter name -> (n_pairs,) int32 array.
      bc: tn93 only — (bc_q, iq, bc_t, it): (nq, 4) / (nt, 4) int32
        A,T,G,C tables for the two sides and (n_pairs,) int32 row
        indices into them.

    Returns:
      (n_pairs,) int64 for integer measures, float64 otherwise.
    """
    if measure in INT_MEASURES:
        return counters["diff"].astype(np.int64)

    n = next(iter(counters.values())).shape[0]
    if out is None or out.shape[0] != n or out.dtype != np.float64:
        out = np.empty(n, dtype=np.float64)
    if bc is not None:
        bcq, iq, bct, it = bc
        bc = (
            np.ascontiguousarray(bcq, dtype=np.int32),
            np.ascontiguousarray(iq, dtype=np.int32),
            np.ascontiguousarray(bct, dtype=np.int32),
            np.ascontiguousarray(it, dtype=np.int32),
        )
    lib = get_lib()
    if lib is not None:
        if n >= 2 * _PAR_CHUNK:
            _finalize_native_parallel(lib, measure, counters, bc, out)
        else:
            _finalize_native(lib, measure, counters, bc, out)
    else:
        _finalize_python(measure, counters, bc, out)
    return out


# The C finalizers release the GIL (plain ctypes calls), so large blocks
# split across a small thread pool — the log/sqrt-heavy measures (jc69,
# k80, tn93) are otherwise a serial ~10 M pairs/s ceiling per core.
_PAR_CHUNK = 1 << 20
_pool = None
_pool_lock = threading.Lock()


def _get_pool():
    """The process-wide pool for GIL-released native passes (finalize
    chunks, diff encode, rel4 finish, transpose gather).  Lock-guarded:
    first use races between the dispatcher and main threads."""
    global _pool
    if _pool is not None:
        return _pool
    with _pool_lock:
        if _pool is None:
            import os
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(
                min(8, os.cpu_count() or 1),
                thread_name_prefix="nativepass",
            )
    return _pool


def _finalize_native_parallel(lib, measure, counters, bc, out):
    n = out.shape[0]
    counters = {k: _as_i32(v) for k, v in counters.items()}
    pool = _get_pool()

    def run(a, b):
        sub = {k: v[a:b] for k, v in counters.items()}
        # the (nq, 4) tables are shared read-only; only the per-pair
        # index slices split across threads
        sub_bc = (bc[0], bc[1][a:b], bc[2], bc[3][a:b]) if bc else None
        _finalize_native(lib, measure, sub, sub_bc, out[a:b])

    futures = [
        pool.submit(run, a, min(a + _PAR_CHUNK, n))
        for a in range(0, n, _PAR_CHUNK)
    ]
    for f in futures:
        f.result()


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _finalize_native(lib, measure, counters, bc, out):
    import ctypes

    n = out.shape[0]
    p_d = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def p32(name):
        arr = _as_i32(counters[name])
        counters[name] = arr  # keep alive
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    if measure == "raw":
        lib.dt_finalize_raw(p32("diff"), p32("same"), p_d, n)
    elif measure == "jc69":
        lib.dt_finalize_jc69(p32("diff"), p32("same"), p_d, n)
    elif measure == "k80":
        lib.dt_finalize_k80(p32("same"), p32("ts"), p32("tv"), p_d, n)
    elif measure == "tn93":
        bcq, iq, bct, it = bc
        pp = ctypes.POINTER(ctypes.c_int32)
        lib.dt_finalize_tn93_gather(
            p32("same"), p32("kk"), p32("p1"), p32("p2"),
            bcq.ctypes.data_as(pp), _as_i32(iq).ctypes.data_as(pp),
            bct.ctypes.data_as(pp), _as_i32(it).ctypes.data_as(pp),
            p_d, n,
        )
    else:
        raise ValueError(f"unknown measure {measure!r}")


def _finalize_python(measure, counters, bc, out):
    n = out.shape[0]
    if measure == "raw":
        diff, same = counters["diff"], counters["same"]
        for i in range(n):
            out[i] = measures.finalize_raw(int(diff[i]), int(same[i]) + int(diff[i]))
    elif measure == "jc69":
        diff, same = counters["diff"], counters["same"]
        for i in range(n):
            out[i] = measures.finalize_jc69(int(diff[i]), int(same[i]) + int(diff[i]))
    elif measure == "k80":
        same, ts, tv = counters["same"], counters["ts"], counters["tv"]
        for i in range(n):
            out[i] = measures.finalize_k80(int(same[i]), int(ts[i]), int(tv[i]))
    elif measure == "tn93":
        same, kk = counters["same"], counters["kk"]
        p1, p2 = counters["p1"], counters["p2"]
        bcq, iq, bct, it = bc
        for i in range(n):
            out[i] = measures.finalize_tn93(
                int(same[i]), int(kk[i]), int(p1[i]), int(p2[i]),
                tuple(bcq[iq[i]]), tuple(bct[it[i]]),
            )
    else:
        raise ValueError(f"unknown measure {measure!r}")
