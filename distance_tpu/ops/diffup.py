"""Diff-encoded host-to-device uploads.

Low-diversity alignments (the reference's design regime — SARS-CoV-2
scale data, /root/reference/src/fastaio.rs:215-286) are overwhelmingly
identical to a per-column consensus: each record differs at a few dozen
of ~30k sites.  Uploading the dense uint8 matrix therefore wastes almost
all of the host->device bandwidth, which is the bottleneck of stream
mode (every streamed record crosses the link once).

This module uploads only the differences: a reference row lives on the
device, and each batch ships (linear index, code) pairs that a jitted
scatter rebuilds into the dense padded matrix on device.  The rebuilt
matrix is byte-identical to the dense upload except for PAD ROWS, which
hold the reference row instead of zeros — pad-row codes never influence
real pairs (each pair reads only its own two rows) and pad COLUMNS stay
zero because the reference row itself is zero-padded.

Exactness is unconditional; wire bytes shrink by ~width/(5 * diffs_per
_record) (int32 index + uint8 code per diff).  Falls back to the dense
chunked upload when the batch is too diverse for the encoding to win.
"""

from __future__ import annotations

import ctypes
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

# The GIL-released native compare/extract passes run on the shared
# process-wide pool (distance_tpu.finalize): the encode runs on the
# engine's dispatcher thread, so parallelizing its two memory passes
# directly shortens the stream critical path.
def _get_pool() -> ThreadPoolExecutor:
    from distance_tpu.finalize import _get_pool as shared

    return shared()


def _row_chunks(n_rows: int, workers: int):
    per = max(256, -(-n_rows // (workers * 2)))
    return [(r0, min(n_rows, r0 + per)) for r0 in range(0, n_rows, per)]

# Pad flat diff lists to one of these capacities so the scatter builder
# compiles once per (shape, capacity) instead of once per batch.
_MIN_CAP = 4096

# Diff upload must shrink wire bytes by at least this factor to be worth
# the device-side rebuild.
_MIN_WIN = 3.0


def _round_cap(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


@functools.lru_cache(maxsize=None)
def _all_device_mesh():
    """Process-constant 1-D "dp" Mesh (cached — rebuilding a Mesh per
    ref_dev/upload call is pure overhead; the device list never changes
    within a process)."""
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()), ("dp",))


@functools.lru_cache(maxsize=None)
def _build_fn(rows_pad: int, l_pad: int, cap: int, sharded: bool = False):
    import jax
    import jax.numpy as jnp

    def build(ref, idx, vals):
        base = jnp.broadcast_to(ref, (rows_pad, l_pad)).reshape(-1)
        # padding entries carry strictly-increasing out-of-bounds indices
        # and are dropped; the sorted+unique promise holds for the whole
        # index vector and lets XLA emit a scatter without conflict
        # handling
        out = base.at[idx].set(
            vals, mode="drop", indices_are_sorted=True, unique_indices=True
        )
        return out.reshape(rows_pad, l_pad)

    if sharded:
        # GSPMD engines consume the rebuilt matrix REPLICATED (same
        # placement the dense sharded upload used); the scatter runs
        # under pjit and only (idx, vals, ref) cross the host link —
        # the multi-chip half of the stream-mode wire win
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.jit(
            build,
            out_shardings=NamedSharding(_all_device_mesh(), P(None, None)),
        )
    return jax.jit(build)


def sampled_mode_row(matrix: np.ndarray, cap: int = 4096) -> np.ndarray:
    """mode_row over an evenly-strided sample of at most ``cap`` rows —
    the shared recipe for picking diff/rel reference rows cheaply."""
    step = max(1, matrix.shape[0] // cap)
    return mode_row(np.ascontiguousarray(matrix[::step][:cap]))


def mode_row(matrix: np.ndarray) -> np.ndarray:
    """Per-column modal code over the matrix — the reference row that
    minimizes expected diffs for records sharing its ancestry."""
    from distance_tpu.encoding import ALL_CODES

    if matrix.shape[0] == 0:
        return np.zeros(matrix.shape[1], dtype=np.uint8)
    best_count = None
    best = np.full(matrix.shape[1], ALL_CODES[0], dtype=np.uint8)
    for code in ALL_CODES:
        count = (matrix == code).sum(axis=0)
        if best_count is None:
            best_count = count.copy()
        else:
            better = count > best_count
            best[better] = code
            np.maximum(best_count, count, out=best_count)
    return best


class DiffUploader:
    """Upload padded row batches against a fixed padded reference row.

    ``sharded``: produce mesh-replicated device arrays for GSPMD
    engines (the dense sharded upload's placement) instead of
    single-device ones."""

    def __init__(self, ref_padded: np.ndarray, sharded: bool = False):
        self.l_pad = int(ref_padded.shape[0])
        self.ref = np.ascontiguousarray(ref_padded, dtype=np.uint8)
        self.sharded = bool(sharded)
        self._ref_dev = None
        disable = os.environ.get("DISTANCE_TPU_NO_DIFF_UPLOAD")
        force = os.environ.get("DISTANCE_TPU_DIFF_UPLOAD") == "force"
        self._min_win = 0.0 if force else (np.inf if disable else _MIN_WIN)

    def ref_dev(self):
        """The reference row as a device array (uploaded once)."""
        import jax
        import jax.numpy as jnp

        if self._ref_dev is None:
            if self.sharded:
                from jax.sharding import NamedSharding, PartitionSpec as P

                self._ref_dev = jax.device_put(
                    self.ref, NamedSharding(_all_device_mesh(), P(None))
                )
            else:
                self._ref_dev = jnp.asarray(self.ref)
        return self._ref_dev

    def encode(self, padded: np.ndarray, n_real: Optional[int] = None):
        """(idx, vals) capacity-padded diff arrays for ``padded``, or
        None when the batch is too diverse for the encoding to win.

        ``idx`` is sorted/unique int32 linear indices with a strictly
        increasing out-of-bounds tail (dropped by the device scatter).
        ``n_real`` (the number of real, non-pad rows) skips the pad-row
        scan when the caller already knows it.
        """
        rows_pad, l_pad = padded.shape
        assert l_pad == self.l_pad, (l_pad, self.l_pad)
        # pad rows are all-zero in `padded` but become `ref` on device;
        # diff only the real (non-pad) prefix — trailing all-zero rows
        # are indistinguishable from pad rows here, and a legitimately
        # all-invalid record encodes as width diffs anyway, never as an
        # accidental pad row (code 0 never equals a nonzero ref entry).
        # Rows of pure padding contribute ref-row diffs vs zero; exclude
        # them by construction: find the last row with any nonzero byte.
        if n_real is None:
            nz_rows = np.flatnonzero(padded.any(axis=1))
            n_real = int(nz_rows[-1]) + 1 if nz_rows.size else 0
        dense_bytes = padded.nbytes
        step = 64
        if n_real > 2 * step:
            # sampled pre-check: when even a 2x-optimistic estimate of
            # the diff volume loses, skip the full-matrix compare
            srows = padded[:n_real:step]
            sdiff = int(np.count_nonzero(srows != self.ref[None, :]))
            est = sdiff * (n_real / srows.shape[0])
            if est * 5 * self._min_win > 2 * dense_bytes:
                return None
        from distance_tpu._native import get_lib

        lib = get_lib()
        if (
            lib is not None
            and n_real >= 512
            and padded.flags.c_contiguous
        ):
            return self._encode_native(
                lib, padded, n_real, rows_pad, l_pad, dense_bytes
            )
        neq = padded[:n_real] != self.ref[None, :]
        # Decide from the cheap COUNT before materializing indices: on a
        # diverse batch flatnonzero would allocate and fill hundreds of
        # MB of indices (measured ~22 s per 8k x 30k group) only to be
        # thrown away by this very test.
        n_diff = int(np.count_nonzero(neq))
        if self._rejects(n_diff, rows_pad, l_pad, dense_bytes):
            return None
        flat = np.flatnonzero(neq.reshape(-1)).astype(np.int32)
        vals = padded.reshape(-1)[flat]
        return self._with_tail(flat, vals, int(flat.size), rows_pad, l_pad)

    def _rejects(
        self, n_diff: int, rows_pad: int, l_pad: int, dense_bytes: int
    ) -> bool:
        diff_bytes = n_diff * 5 + self.l_pad
        return diff_bytes * self._min_win > dense_bytes or (
            # int32 linear indices (incl. the OOB pad tail) must not wrap
            rows_pad * l_pad + _round_cap(n_diff) >= 1 << 31
        )

    @staticmethod
    def _with_tail(idx_part, val_part, n_diff, rows_pad, l_pad):
        """Capacity-pad (idx, vals) with a strictly-increasing
        out-of-bounds index tail (dropped by the device scatter) so the
        whole index vector stays sorted and unique."""
        cap = _round_cap(n_diff)
        idx = np.empty(cap, dtype=np.int32)
        idx[:n_diff] = idx_part[:n_diff]
        idx[n_diff:] = np.arange(
            rows_pad * l_pad, rows_pad * l_pad + (cap - n_diff),
            dtype=np.int64,
        ).astype(np.int32)
        v = np.zeros(cap, dtype=np.uint8)
        v[:n_diff] = val_part[:n_diff]
        return idx, v

    def _encode_native(
        self, lib, padded, n_real, rows_pad, l_pad, dense_bytes
    ):
        """Two GIL-released C passes (count, then extract), each chunked
        over rows across the module pool — measured ~10x the numpy
        compare+flatnonzero path on winning groups, off the dispatcher
        thread's critical path."""
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        ref_p = self.ref.ctypes.data_as(p_u8)
        pool = _get_pool()
        chunks = _row_chunks(n_real, pool._max_workers)

        def count(span):
            r0, r1 = span
            return lib.dt_diff_count(
                padded[r0:r1].ctypes.data_as(p_u8), ref_p, r1 - r0, l_pad
            )

        counts = list(pool.map(count, chunks)) if len(chunks) > 1 else [
            count(chunks[0])
        ]
        n_diff = int(sum(counts))
        if self._rejects(n_diff, rows_pad, l_pad, dense_bytes):
            return None
        cap = _round_cap(n_diff)
        idx = np.empty(cap, dtype=np.int32)
        vals = np.zeros(cap, dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        def fill(k):
            r0, r1 = chunks[k]
            o = int(offs[k])
            w = lib.dt_diff_fill(
                padded[r0:r1].ctypes.data_as(p_u8), ref_p, r1 - r0, l_pad,
                r0 * l_pad,
                idx[o:].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vals[o:].ctypes.data_as(p_u8),
            )
            assert w == counts[k], (w, counts[k])

        if len(chunks) > 1:
            list(pool.map(fill, range(len(chunks))))
        else:
            fill(0)
        idx[n_diff:] = np.arange(
            rows_pad * l_pad, rows_pad * l_pad + (cap - n_diff),
            dtype=np.int64,
        ).astype(np.int32)
        return idx, vals

    def upload(self, padded: np.ndarray):
        """Device (rows_pad, l_pad) uint8 array; diff-encoded when the
        batch is low-diversity, else the dense chunked fallback."""
        from distance_tpu.engine import _chunked_h2d

        enc = self.encode(padded)
        if enc is None:
            if self.sharded:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                return jax.device_put(
                    padded,
                    NamedSharding(_all_device_mesh(), P(None, None)),
                )
            return _chunked_h2d(padded)
        return self.upload_encoded(enc, padded.shape[0])

    def upload_encoded(self, enc, rows_pad: int):
        """Device rebuild from an already-computed (idx, vals) encoding —
        the fast path for re-staged super-rows (out-of-core sweeps),
        where the host pad/compare/extract passes were memoized away and
        only the scatter build + the small diff H2D remain."""
        idx, v = enc
        build = _build_fn(rows_pad, self.l_pad, int(idx.shape[0]),
                          self.sharded)
        import jax.numpy as jnp

        return build(self.ref_dev(), jnp.asarray(idx), jnp.asarray(v))
