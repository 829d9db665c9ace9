"""Run orchestration: setup, tiled pairwise sweeps, ordered emission.

Accelerator counterpart of the reference's thread pipeline
(/root/reference/src/lib.rs:269-498).  Where the reference streams pair
batches through a worker pool over crossbeam channels, this engine:

* uploads the packed alignment once to device memory;
* sweeps the pair-index space in (strip x block) tiles, each tile one
  device dispatch of the int8 counter GEMM (ops/);
* relies on JAX async dispatch for pipelining (the bounded-channel
  backpressure analog is the bounded number of in-flight tiles);
* finalizes counters to f64 on host (exact glibc libm) and emits TSV rows
  in canonical order — row-major upper triangle within one alignment,
  file1 x file2 row-major between two, loaded-major per streamed record in
  stream mode (matching lib.rs:502-596, 322-333).

Output bytes are identical regardless of tile sizes or device count — the
determinism oracle the reference enforces with its reorder buffer.
"""

from __future__ import annotations

import functools
import os as _os
import sys
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distance_tpu.fastaio import (
    Alignment,
    DistanceError,
    consensus as consensus_fn,
    load_fastas,
    stream_fasta,
)
from distance_tpu.finalize import finalize_block
from distance_tpu.ops.features import CounterPlan, features_device, get_plan
from distance_tpu.utils.timing import phase_timer
from distance_tpu.writer import TsvWriter

# Pair-tile sizes: strips of TILE_I rows against blocks of TILE_J
# columns.  0 = auto: square tiles sized to the sweep (see _auto_tile) —
# larger tiles feed the GEMM better while diagonal-block waste grows as
# tile/n, so the best tile is scale-dependent.
TILE_I = 0
TILE_J = 0
# Streamed records grouped into device dispatches of about this many rows.
DEV_BATCH_ROWS = 512
# Stream groups kept in flight (dispatched, not yet fetched); deeper than
# double buffering so per-request transfer latency stays hidden.
STREAM_PENDING = int(_os.environ.get("DISTANCE_TPU_STREAM_PENDING", 3))
# After this many consecutive narrow-pack saturations, dispatch wide.
NARROW_STICKY_LIMIT = int(_os.environ.get("DISTANCE_TPU_NARROW_STICKY", 2))
# Consecutive failed stream-reference retargets before the engine stops
# probing new references (see _BlockEngine.dispatch_stream).
RETARGET_FAIL_LIMIT = int(_os.environ.get("DISTANCE_TPU_RETARGET_LIMIT", 3))
# Below this many pair-sites the NumPy path beats device dispatch+compile.
SMALL_PROBLEM_PAIRSITES = 5e7


@dataclass
class Setup:
    """Resolved run configuration (analog of lib.rs:133-160)."""

    loaded: List[Alignment]
    streamed: Optional[BinaryIO]
    writer: TsvWriter
    measure: str
    n_threads: int
    batchsize: int
    backend: str = "auto"  # auto | numpy | xla
    consensus: Optional[np.ndarray] = None
    tile_i: int = TILE_I
    tile_j: int = TILE_J
    # Multi-host sharding: (k, N) — this process handles the k-th of N
    # balanced contiguous row-strip ranges; concatenating the N outputs
    # in k order reproduces the single-host file byte-for-byte.
    shard: Optional[Tuple[int, int]] = None
    # Checkpoint/resume sidecar (see progress.py); None disables.
    progress: Optional[object] = None
    # Input-file fingerprints recorded in the progress sidecar so --resume
    # refuses to continue against changed inputs.
    input_fp: Optional[List[dict]] = None
    # Output path (None for stdout) — sharded stream runs keep a .units
    # sidecar next to it for the multi-host merge.
    out_path: Optional[str] = None


def set_up(args) -> Setup:
    """Build a Setup from parsed CLI arguments (argparse namespace).

    Mirrors /root/reference/src/lib.rs:162-267: input resolution
    (positional xor -i, stdin default), stream handling, measure
    precompute (consensus for ``n``, base counts for ``tn93``), writer and
    thread/batch settings.
    """
    pos_inputs = [p for p in (args.input_pos_1, args.input_pos_2) if p]
    flag_inputs = list(args.input or [])
    if pos_inputs and flag_inputs:
        raise DistanceError(
            "For loading input files, don't use both positional arguments"
            " and the -i/--input flag"
        )
    consolidated = flag_inputs + pos_inputs

    handles: List[BinaryIO] = []
    if not consolidated:
        handles.append(sys.stdin.buffer)
    for path in consolidated:
        handles.append(open(path, "rb"))

    streamed: Optional[BinaryIO] = None
    if args.stream is not None:
        if len(consolidated) != 1:
            raise DistanceError(
                "If you stream one file, you must also provide exactly one"
                " other file to be loaded"
            )
        streamed = sys.stdin.buffer if args.stream == "-" else open(args.stream, "rb")

    with phase_timer("load+encode"):
        loaded = load_fastas(handles)

    cons = None
    if args.measure == "n":
        # One-time host reduction (lib.rs:223-231).  The dense device GEMM
        # does not need per-record difference lists; the consensus is kept
        # for the streamed-mode contract and the sparse host path.
        with phase_timer("consensus"):
            cons = consensus_fn(loaded)
    elif args.measure == "tn93":
        with phase_timer("count_bases"):
            backend_req = getattr(args, "backend", "auto") or "auto"
            for aln in loaded:
                _count_bases_maybe_device(aln, backend_req)

    tracker = None
    input_fp = None
    resume = bool(getattr(args, "resume", False))
    if resume:
        if args.output is None:
            raise DistanceError("--resume requires -o/--output")
        from distance_tpu.progress import ProgressTracker

        # Fingerprint the inputs so a resume against swapped/edited files
        # is refused instead of silently appending mismatched rows.
        fp_paths = list(consolidated)
        if args.stream not in (None, "-"):
            fp_paths.append(args.stream)
        input_fp = _input_fingerprint(fp_paths)
        tracker = ProgressTracker(args.output)
        if tracker.load() and _os.path.exists(args.output):
            out = open(args.output, "r+b")
            out.truncate(tracker.byte_offset)
            out.seek(tracker.byte_offset)
        else:
            tracker.units_done = 0
            tracker.byte_offset = 0
            out = open(args.output, "wb")
    else:
        out = (
            sys.stdout.buffer if args.output is None
            else open(args.output, "wb")
        )

    if args.threads is None:
        # omitting -t "spins up the number of available CPUs"
        # (/root/reference/src/lib.rs:262) — the default pool is sized
        # from the machine, not a fixed constant.  Transfer threads
        # block on the device link rather than burning CPU, so the
        # default pool oversubscribes cores (measured 2.2x stream
        # throughput at 4x on a latency-bound link); an explicit -t
        # remains an exact override.
        n_threads = _os.cpu_count() or 1
        configure_fetch_pool(min(32, 4 * n_threads))
    else:
        n_threads = max(1, args.threads)
        configure_fetch_pool(n_threads)

    shard = None
    shard_arg = getattr(args, "shard", None)
    if shard_arg:
        try:
            k_s, n_s = shard_arg.split("/")
            shard = (int(k_s), int(n_s))
        except ValueError:
            raise DistanceError(
                f"Invalid --shard '{shard_arg}': expected K/N"
            ) from None
        if shard[1] < 1 or not (0 <= shard[0] < shard[1]):
            raise DistanceError(
                f"Invalid --shard '{shard_arg}': need 0 <= K < N"
            )

    return Setup(
        loaded=loaded,
        streamed=streamed,
        writer=TsvWriter(
            out, on_broken_pipe=tracker.clear if tracker else None
        ),
        measure=args.measure,
        n_threads=n_threads,
        batchsize=max(1, args.batchsize),
        backend=getattr(args, "backend", "auto") or "auto",
        consensus=cons,
        shard=shard,
        progress=tracker,
        input_fp=input_fp,
        out_path=args.output,
    )


def _input_fingerprint(paths: Sequence[str]) -> List[dict]:
    """Cheap input identity for resume safety: per-file size plus a hash
    of the first and last 64 KiB (content-based; mtime alone is too
    brittle across copies)."""
    import hashlib

    fps: List[dict] = []
    for p in paths:
        st = _os.stat(p)
        h = hashlib.blake2b(digest_size=16)
        with open(p, "rb") as f:
            h.update(f.read(1 << 16))
            if st.st_size > (1 << 16):
                f.seek(max(1 << 16, st.st_size - (1 << 16)))
                h.update(f.read(1 << 16))
        fps.append(
            {
                "path": _os.path.abspath(p),
                "size": st.st_size,
                "hash": h.hexdigest(),
            }
        )
    return fps


# Count tn93 bases on-device for matrices at least this large (opt-in
# via DISTANCE_TPU_BASECOUNT_DEVICE_MIN).  Default off: the host count
# is one GIL-released native pass (fastaio.dt_count_bases), and the
# count's dense H2D cannot reuse the sweep's diff-encoded upload, so a
# separate upload only pays on a fast link with a starved host.
BASE_COUNT_DEVICE_MIN_BYTES = int(
    _os.environ.get("DISTANCE_TPU_BASECOUNT_DEVICE_MIN", 1 << 62)
)


def _count_bases_maybe_device(aln: Alignment, backend: str) -> None:
    if (
        backend != "numpy"
        and aln.matrix.nbytes >= BASE_COUNT_DEVICE_MIN_BYTES
    ):
        try:
            aln.base_counts = _count_bases_device(aln.matrix)
            return
        except Exception:
            pass  # no usable device: the host path is always correct
    aln.count_bases()


def _count_bases_device(matrix: np.ndarray) -> np.ndarray:
    """tn93 base-count precompute as a device reduction
    (ops/pairwise_xla.base_counts_device), chunked through HBM."""
    import jax.numpy as jnp

    from distance_tpu.ops.pairwise_xla import base_counts_device

    rows_per = max(1, H2D_CHUNK_BYTES // max(1, matrix.shape[1]))
    outs = []
    for r0 in range(0, matrix.shape[0], rows_per):
        dev = jnp.asarray(np.ascontiguousarray(matrix[r0 : r0 + rows_per]))
        outs.append(np.asarray(base_counts_device(dev)).astype(np.int32))
    return np.concatenate(outs)


def run(setup: Setup) -> None:
    """Dispatch to the in-memory or streamed driver (lib.rs:490-498)."""
    if setup.shard is not None and setup.shard[0] != 0:
        setup.writer.suppress_header()
    _resolve_auto_tiles(setup)
    if setup.progress is not None:
        cfg = {
            "measure": setup.measure,
            "tile_i": setup.tile_i,
            "tile_j": setup.tile_j,
            "shard": list(setup.shard) if setup.shard else None,
            "mode": "stream" if setup.streamed is not None else "load",
            # stream-mode emission groups depend on the batch size and
            # the device group size (resume counts emitted groups)
            "batchsize": setup.batchsize,
            "stream_group": (
                _stream_group_rows(setup.loaded[0].n)
                if setup.streamed is not None else None
            ),
            "inputs": setup.input_fp,
        }
        mismatch = setup.progress.check_config(cfg)
        if mismatch:
            raise DistanceError(f"Cannot resume: {mismatch}")
        if setup.progress.byte_offset > 0:
            setup.writer.suppress_header()
    try:
        if setup.streamed is not None:
            with phase_timer("stream-sweep"):
                _run_stream(setup)
        else:
            with phase_timer("load-sweep"):
                _run_load(setup)
        setup.writer.flush()
        if setup.progress is not None:
            setup.progress.clear()
    finally:
        try:
            setup.writer.flush()
        except Exception:
            pass
        from distance_tpu.utils import timing

        if timing.enabled():
            for name, secs in sorted(timing.totals().items()):
                print(f"[distance-tpu] total {name}: {secs:.3f} s",
                      file=sys.stderr)


def _resume_skip(setup: Setup) -> int:
    """Number of already-completed emission units to skip."""
    if setup.progress is None:
        return 0
    return setup.progress.units_done


def _progress_mark(setup: Setup, units_done: int) -> None:
    """Checkpoint after one emission unit: flush, record byte offset."""
    if setup.progress is None:
        return
    setup.writer.flush()
    try:
        offset = setup.writer.tell()
    except (OSError, AttributeError):
        return
    setup.progress.record(units_done, offset)


# ---------------------------------------------------------------------------
# Counter block computation (backend dispatch)
# ---------------------------------------------------------------------------

def _counters_numpy(x: np.ndarray, y: np.ndarray, plan: CounterPlan) -> np.ndarray:
    """Exact NumPy fallback of the counter GEMM (small problems, tests)."""
    fx = features_device(x, plan, "f", np, np.int32)  # (R, m, L)
    gy = features_device(y, plan, "g", np, np.int32)
    if plan.mix_num is not None:
        o = np.einsum("rml,rnl->rmn", fx, gy)
        c = np.tensordot(plan.mix_num, o, axes=([1], [0]))
        return (c // plan.mix_den[:, None, None]).astype(np.int32)
    outs = []
    for name in plan.counters:
        lo, hi = plan.slice_of(name)
        outs.append(np.einsum("rml,rnl->mn", fx[lo:hi], gy[lo:hi]))
    return np.stack(outs).astype(np.int32)


def _resolve_backend(backend: str, pairsites: float) -> str:
    if backend != "auto":
        return backend
    if pairsites <= SMALL_PROBLEM_PAIRSITES:
        return "numpy"
    return "xla"


@functools.lru_cache(maxsize=None)
def _mesh_all_devices():
    """The process-constant 1-D "dp" Mesh over all local devices (cached:
    the device list never changes within a process)."""
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()), ("dp",))


def _device_mesh(n_blocks: int):
    """A 1-D "dp" mesh over all local devices, if block columns divide
    evenly; None for single-device runs.  The divisibility decision stays
    live (tests pin jax.device_count); only the Mesh object is cached."""
    import jax

    ndev = jax.device_count()
    if ndev <= 1 or n_blocks % ndev != 0:
        return None
    return _mesh_all_devices()


def _replicated_put(arr: np.ndarray, tj: int):
    """Dense H2D replicated over the dp mesh — the sharded engines' dense
    fallback when no diff encoding applies (GSPMD then splits the GEMM's
    column axis; the sequence matrix itself is replicated)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(
        arr, NamedSharding(_device_mesh(tj), P(*(None,) * arr.ndim))
    )


@functools.lru_cache(maxsize=None)
def _jit_block_fn(measure: str, ti: int, tj: int,
                  pack_mode: str = "none", width: int = 0,
                  sharded: bool = False, diag_mask: bool = False):
    """Jitted (mat1, mat2, i0, j0) -> counter block.

    ``pack_mode``: "none" -> (G, ti, tj) int32; "wide"/"narrow" -> the
    packed representations from ops/packing.py — packing runs on device
    so the device->host transfer shrinks to 1-8 bytes per pair.

    ``sharded``: partition the block's column (target) axis across all
    devices — the sequence matrix is replicated, GSPMD splits the GEMM so
    each chip computes tj/n_devices columns (pair-data parallelism;
    statically balanced since every tile costs the same).
    """
    import jax
    import jax.numpy as jnp

    from distance_tpu.ops.packing import (
        pack_device, pack_device_narrow, pack_device_rel, pack_device_rel4,
    )

    from distance_tpu.ops.pairwise_xla import counters_xla as kern

    plan = get_plan(measure)
    if pack_mode in ("rel", "rel4"):
        # rank-1 baseline residuals (ops/packing.py): per block, int8
        # lanes (two 4-bit lanes per byte under rel4) + this block's
        # column baselines + the strip-constant row baselines /
        # self-counter (identical across a strip's blocks — the fetch
        # uses any one copy)
        def f(m1, m2, i0, j0, ref, nv1, nv2, doff):
            x = jax.lax.dynamic_slice(m1, (i0, 0), (ti, m1.shape[1]))
            y = jax.lax.dynamic_slice(m2, (j0, 0), (tj, m2.shape[1]))
            c = kern(x, y, plan)
            ref2 = ref[None, :]
            rb = kern(x, ref2, plan)[:, :, 0]     # (G, ti)
            cb = kern(ref2, y, plan)[:, 0, :]     # (G, tj)
            cc = kern(ref2, ref2, plan)[:, 0, 0]  # (G,)
            ri = jnp.arange(ti) + i0
            cj = jnp.arange(tj) + j0
            mask = None
            if diag_mask:
                # square sweep over one source: equal GLOBAL indices are
                # self-pairs — never emitted, and their residual (-2*rb)
                # saturates for any record >63 counts from the
                # reference.  ``doff`` maps local to global: m1 row r is
                # global r+off1, m2 row c is global c+off2, self-pair
                # iff ri + (off1-off2) == cj (out-of-core row groups
                # stage the same source at different offsets)
                mask = (ri[:, None] + doff) == cj[None, :]
            rb_cc = jnp.concatenate([rb, cc[:, None]], axis=1)
            if pack_mode == "rel4":
                # padding rows/cols saturate by construction (their
                # residual is +cc); zero them so they cannot flood the
                # exception sidecar — they are cropped on host anyway
                pad = (ri[:, None] >= nv1) | (cj[None, :] >= nv2)
                mask = pad if mask is None else (mask | pad)
                lanes, exc_idx, exc_val = pack_device_rel4(
                    c, rb, cb, cc, jnp, mask
                )
                return lanes, cb, rb_cc, exc_idx, exc_val
            lanes = pack_device_rel(c, rb, cb, cc, jnp, mask)
            return lanes, cb, rb_cc
    else:
        def f(m1, m2, i0, j0):
            x = jax.lax.dynamic_slice(m1, (i0, 0), (ti, m1.shape[1]))
            y = jax.lax.dynamic_slice(m2, (j0, 0), (tj, m2.shape[1]))
            c = kern(x, y, plan)
            if pack_mode == "narrow":
                return pack_device_narrow(measure, c, width, jnp)
            if pack_mode == "wide":
                return pack_device(measure, c, jnp)
            return c

    if sharded:
        mesh = _device_mesh(tj)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if pack_mode in ("rel", "rel4"):
                shards = [
                    NamedSharding(mesh, P(None, None, "dp")),
                    NamedSharding(mesh, P(None, "dp")),
                    NamedSharding(mesh, P(None, None)),
                ]
                if pack_mode == "rel4":  # exception sidecar: replicated
                    shards += [
                        NamedSharding(mesh, P(None)),
                        NamedSharding(mesh, P(None)),
                    ]
                return jax.jit(f, out_shardings=tuple(shards))
            return jax.jit(
                f,
                out_shardings=NamedSharding(mesh, P(None, None, "dp")),
            )
    return jax.jit(f)


def _env_bytes(name: str) -> Optional[int]:
    v = _os.environ.get(name)
    return int(v) if v else None


# Device memory allowed for the persistent g-side feature cache
# (R x n_pad x l_pad int8 per prepared matrix), so block dispatches do not
# rebuild these features.  None derives it from the device
# (_featcache_budget); 0 disables.
FEATCACHE_BUDGET: Optional[int] = _env_bytes("DISTANCE_TPU_FEATCACHE_BUDGET")
# Share of the device's memory limit (what the JAX process may allocate)
# given to each derived budget.  The other half is left for XLA's
# temporaries: per-strip features, GEMM workspace and packed outputs.
DEVICE_BUDGET_SHARE = 0.5
# Budget for devices that report no memory limit (the CPU backend).
FALLBACK_BUDGET_BYTES = 8 << 30


@functools.lru_cache(maxsize=None)
def _device_budget() -> int:
    """DEVICE_BUDGET_SHARE of the first device's ``bytes_limit``, or
    FALLBACK_BUDGET_BYTES when the device reports none.  Resolved on
    first use, so importing the engine never initializes a backend."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return FALLBACK_BUDGET_BYTES
    return int(limit * DEVICE_BUDGET_SHARE)


def _featcache_budget() -> int:
    if FEATCACHE_BUDGET is not None:
        return FEATCACHE_BUDGET
    return _device_budget()


def _hbm_budget() -> int:
    if HBM_BUDGET_BYTES is not None:
        return HBM_BUDGET_BYTES
    return _device_budget()


def _jit_replicated3(f, repl: bool):
    """jit a rank-3-output fn, optionally pinning the output REPLICATED
    across the all-device "dp" mesh — sharded engines consume strip and
    reference feature tensors whole on every chip.

    NOT memoized here: every caller is itself an lru_cached factory
    (so each unique key reaches this exactly once).  A closure-keyed
    lru_cache at this level is a trap — a caller that builds a fresh
    closure per call (the 205af23 regression on _jit_feat_builder)
    never hits it and leaks one compiled executable per call; see
    tests/test_jit_factories.py for the identity pins."""
    import jax

    if not repl:
        return jax.jit(f)
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("dp",))
    return jax.jit(
        f, out_shardings=NamedSharding(mesh, P(None, None, None))
    )


@functools.lru_cache(maxsize=None)
def _jit_feat_builder(measure: str, side: str, repl: bool = False):
    """codes (n, L) -> (R, n, L) int8 feature tensor, on device.

    ``repl``: pin the output replicated across the device mesh (used by
    sharded engines for strip/reference features, which every chip's
    block contraction consumes whole)."""
    import jax.numpy as jnp

    plan = get_plan(measure)

    def f(codes):
        return features_device(codes, plan, side, jnp, jnp.int8)

    return _jit_replicated3(f, repl)


@functools.lru_cache(maxsize=None)
def _jit_feat_builder_blocked(measure: str, tj: int):
    """codes (n_pad, l_pad) -> (nb, R, tj, l_pad) int8 g-features for
    sharded (GSPMD) engines, block-partitioned so every tj-aligned block
    slice is shard-local under the blocks' column ("dp") sharding.

    A flat (R, n_pad, L) cache cannot carry the column partition — a
    tj-row slice at j0 would cross contiguous row shards — but reshaping
    rows into (nb, tj) blocks and sharding the tj axis gives each chip
    exactly its tj/ndev columns of EVERY block, so a block lookup is a
    local index on the unsharded nb axis.  The block axis is OUTERMOST
    so an nb-index yields a fully contiguous (R, tj, L) operand — with
    nb inside R, the slice is strided on R and XLA copies the whole
    ~R*tj*L block to compact it before the GEMM.  Rows pad to a multiple of tj
    with zero feature rows (code 0 evaluates to 0 in every channel —
    same bytes as padding the codes first)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    plan = get_plan(measure)
    r = plan.total_channels
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("dp",))

    def f(codes):
        g = features_device(codes, plan, "g", jnp, jnp.int8)
        n_pad = codes.shape[0]
        nbp = -(-n_pad // tj) * tj
        if nbp != n_pad:
            g = jnp.pad(g, ((0, 0), (0, nbp - n_pad), (0, 0)))
        g = g.reshape(r, nbp // tj, tj, codes.shape[1])
        return jnp.transpose(g, (1, 0, 2, 3))

    return jax.jit(
        f, out_shardings=NamedSharding(mesh, P(None, None, "dp", None))
    )


@functools.lru_cache(maxsize=None)
def _jit_fx_strip(measure: str, ti: int, repl: bool = False):
    """(codes, i0) -> (R, ti, L) f-side features of one strip.

    Built once per strip and reused by all its column blocks (the old
    path rebuilt them per block; n/tj times more often).  ``repl`` pins
    the output replicated for sharded engines."""
    import jax
    import jax.numpy as jnp

    plan = get_plan(measure)

    def f(codes, i0):
        x = jax.lax.dynamic_slice(codes, (i0, 0), (ti, codes.shape[1]))
        return features_device(x, plan, "f", jnp, jnp.int8)

    return _jit_replicated3(f, repl)


@functools.lru_cache(maxsize=None)
def _jit_fx_slice(measure: str, ti: int, repl: bool = False):
    """(ffull, i0) -> (R, ti, L) slice of a cached f-feature tensor."""
    import jax

    plan = get_plan(measure)
    r = plan.total_channels

    def f(ffull, i0):
        return jax.lax.dynamic_slice(
            ffull, (0, i0, 0), (r, ti, ffull.shape[2])
        )

    return _jit_replicated3(f, repl)


@functools.lru_cache(maxsize=None)
def _jit_block_fn_feat(measure: str, ti: int, tj: int,
                       pack_mode: str = "none", width: int = 0,
                       diag_mask: bool = False, sharded: bool = False):
    """Cached-feature analog of _jit_block_fn: contraction + packing over
    prebuilt feature tensors (f-side per strip via _jit_fx_strip, g-side
    per matrix via _jit_feat_builder), so no features are rebuilt inside
    the block dispatch.  Same outputs, byte-identical counters (integer
    GEMMs over identical operands).

    ``sharded`` (GSPMD): ``gyf`` arrives block-partitioned as
    (nb, R, tj, l_pad) with the tj axis sharded over the "dp" mesh
    (_jit_feat_builder_blocked), so the block lookup is a shard-local
    index on the leading nb axis (a contiguous (R, tj, L) operand) and
    the contraction inherits the blocks' column sharding — multi-chip
    sweeps get the same cached-feature win as single-chip ones.
    Requires tj-aligned column starts (the engine falls back to the
    recomputing path otherwise)."""
    import jax
    import jax.numpy as jnp

    from distance_tpu.ops.packing import (
        pack_device, pack_device_narrow, pack_device_rel, pack_device_rel4,
    )
    from distance_tpu.ops.pairwise_xla import contract_features

    plan = get_plan(measure)
    r = plan.total_channels

    if sharded:
        def slice_gy(gyf, j0):
            return jax.lax.dynamic_index_in_dim(
                gyf, j0 // tj, axis=0, keepdims=False
            )
    else:
        def slice_gy(gyf, j0):
            return jax.lax.dynamic_slice(
                gyf, (0, j0, 0), (r, tj, gyf.shape[2])
            )

    if pack_mode in ("rel", "rel4"):
        def f(fx, gyf, i0, j0, f_ref, g_ref, nv1, nv2, doff):
            gy = slice_gy(gyf, j0)
            c = contract_features(fx, gy, plan)
            rb = contract_features(fx, g_ref, plan)[:, :, 0]   # (G, ti)
            cb = contract_features(f_ref, gy, plan)[:, 0, :]   # (G, tj)
            cc = contract_features(f_ref, g_ref, plan)[:, 0, 0]  # (G,)
            ri = jnp.arange(ti) + i0
            cj = jnp.arange(tj) + j0
            mask = None
            if diag_mask:
                # self-pair cells (see _jit_block_fn): never emitted and
                # saturating, so masked out of the residual lanes
                mask = (ri[:, None] + doff) == cj[None, :]
            rb_cc = jnp.concatenate([rb, cc[:, None]], axis=1)
            if pack_mode == "rel4":
                pad = (ri[:, None] >= nv1) | (cj[None, :] >= nv2)
                mask = pad if mask is None else (mask | pad)
                lanes, exc_idx, exc_val = pack_device_rel4(
                    c, rb, cb, cc, jnp, mask
                )
                return lanes, cb, rb_cc, exc_idx, exc_val
            lanes = pack_device_rel(c, rb, cb, cc, jnp, mask)
            return lanes, cb, rb_cc
    else:
        def f(fx, gyf, j0):
            c = contract_features(fx, slice_gy(gyf, j0), plan)
            if pack_mode == "narrow":
                return pack_device_narrow(measure, c, width, jnp)
            if pack_mode == "wide":
                return pack_device(measure, c, jnp)
            return c

    if sharded:
        mesh = _device_mesh(tj)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if pack_mode in ("rel", "rel4"):
                shards = [
                    NamedSharding(mesh, P(None, None, "dp")),
                    NamedSharding(mesh, P(None, "dp")),
                    NamedSharding(mesh, P(None, None)),
                ]
                if pack_mode == "rel4":  # exception sidecar: replicated
                    shards += [
                        NamedSharding(mesh, P(None)),
                        NamedSharding(mesh, P(None)),
                    ]
                return jax.jit(f, out_shardings=tuple(shards))
            return jax.jit(
                f,
                out_shardings=NamedSharding(mesh, P(None, None, "dp")),
            )
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jit_stream_fn(measure: str, ti: int, rows_pad: int,
                   n1_pad: int, pack_mode: str, width: int, l_pad: int,
                   cap: Optional[int], sharded: bool):
    """One fused jitted call per stream group.

    Rebuilds the streamed batch from (index, code) diffs when ``cap`` is
    set (ops/diffup.py), sweeps every loaded strip against it with an
    in-graph ``lax.map``, and packs — one device round-trip per group
    instead of a rebuild call plus one call per strip, so per-operation
    dispatch latency is paid once per group.
    """
    import jax
    import jax.numpy as jnp

    from distance_tpu.ops.packing import (
        bundle_sidecars, pack_device, pack_device_narrow, pack_device_rel,
        pack_device_rel4,
    )

    from distance_tpu.ops.pairwise_xla import counters_xla as kern

    plan = get_plan(measure)
    n_strips = n1_pad // ti

    def sweep(m1, y):
        if n_strips <= 1:
            return kern(m1, y, plan)
        i0s = jnp.arange(n_strips, dtype=jnp.int32) * ti

        def body(i0):
            x = jax.lax.dynamic_slice(m1, (i0, 0), (ti, m1.shape[1]))
            return kern(x, y, plan)

        c = jax.lax.map(body, i0s)  # (S, G, ti, rows_pad)
        return jnp.moveaxis(c, 0, 1).reshape(-1, n1_pad, rows_pad)

    def finish(c, m1=None, y=None, ref=None, nv1=None, nv2=None):
        if pack_mode in ("rel", "rel4"):
            # rank-1 baseline correction (ops/packing.py): residual
            # lanes int8 (4-bit pairs + exception sidecar under rel4)
            # + two small int32 baseline arrays
            ref2 = ref[None, :]
            rb = kern(m1, ref2, plan)[:, :, 0]      # (G, n1_pad)
            cb = kern(ref2, y, plan)[:, 0, :]       # (G, rows_pad)
            cc = kern(ref2, ref2, plan)[:, 0, 0]    # (G,)
            rb_cc = jnp.concatenate([rb, cc[:, None]], axis=1)
            if pack_mode == "rel4":
                # zero padding cells (loaded rows >= nv1, streamed rows
                # >= nv2): their residuals saturate by construction and
                # would flood the exception sidecar
                pad = (jnp.arange(n1_pad)[:, None] >= nv1) | (
                    jnp.arange(rows_pad)[None, :] >= nv2
                )
                lanes, exc_idx, exc_val = pack_device_rel4(
                    c, rb, cb, cc, jnp, pad
                )
                # one fused D2H for every small array (transfers are
                # charged per request)
                return lanes, bundle_sidecars(
                    jnp, cb, rb_cc, exc_idx, exc_val
                )
            lanes = pack_device_rel(c, rb, cb, cc, jnp)
            return lanes, bundle_sidecars(jnp, cb, rb_cc)
        if pack_mode == "narrow":
            return pack_device_narrow(measure, c, width, jnp)
        if pack_mode == "wide":
            return pack_device(measure, c, jnp)
        return c

    if cap is None and pack_mode not in ("rel", "rel4"):
        def f(m1, y):
            return finish(sweep(m1, y))
    elif cap is None:
        def f(m1, ref, y, nv1, nv2):
            return finish(sweep(m1, y), m1, y, ref, nv1, nv2)
    else:
        def f(m1, ref, idx, vals, nv1, nv2):
            base = jnp.broadcast_to(ref, (rows_pad, l_pad)).reshape(-1)
            y = base.at[idx].set(
                vals, mode="drop", indices_are_sorted=True,
                unique_indices=True,
            ).reshape(rows_pad, l_pad)
            return finish(sweep(m1, y), m1, y, ref, nv1, nv2)

    if sharded:
        mesh = _device_mesh(rows_pad)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if pack_mode in ("rel", "rel4"):
                # lanes column-sharded; the fused sidecar bundle is
                # replicated (tiny, and fetched once)
                shards = (
                    NamedSharding(mesh, P(None, None, "dp")),
                    NamedSharding(mesh, P(None)),
                )
                return jax.jit(f, out_shardings=shards)
            return jax.jit(
                f, out_shardings=NamedSharding(mesh, P(None, None, "dp"))
            )
    return jax.jit(f)


def _stream_group_rows(n1: int) -> int:
    """Streamed records per device dispatch: target ~16M pairs per group
    so per-dispatch latency amortizes, bounded at 8192 rows for device
    feature temporaries.  DISTANCE_TPU_STREAM_GROUP overrides."""
    env = _os.environ.get("DISTANCE_TPU_STREAM_GROUP")
    if env:
        # even: rel4 nibble lanes pack the streamed axis two per byte
        return max(2, int(env) + (int(env) & 1))
    target = int(
        _os.environ.get("DISTANCE_TPU_STREAM_GROUP_PAIRS", 16 << 20)
    ) // max(1, n1)
    return max(DEV_BATCH_ROWS, min(8192, _pow2_at_least(target)))


class _BlockEngine:
    """Computes counter blocks for (strip, block) tile pairs.

    Handles padding, device upload, and backend selection; returns numpy
    int32 arrays.  The same object serves square, rectangle, and stream
    sweeps.
    """

    def __init__(self, measure: str, backend: str, ti: int, tj: int,
                 width: int = 0):
        self.measure = measure
        self.plan = get_plan(measure)
        self.backend = backend
        self.ti = ti
        self.tj = tj
        self.width = width
        from distance_tpu.ops.packing import PACK_LIMIT

        self.packed = backend != "numpy" and 0 < width < PACK_LIMIT
        # Multi-chip pair-data parallelism (xla backend): replicate the
        # matrix, shard each block's column axis across the device mesh.
        self.sharded = backend == "xla" and _device_mesh(tj) is not None
        # rel4 halves the lanes' column axis; under GSPMD that halved
        # axis must still divide the device count or pjit rejects the
        # output sharding — fall to the int8 rel rung otherwise.
        self._rel4_shard_ok = True
        if self.sharded:
            import jax

            self._rel4_shard_ok = (tj // 2) % jax.device_count() == 0
        # Diff-encoded uploads (ops/diffup.py): set by prepare(diff_ref=)
        self.diff_up = None
        # identity of the diff_ref array the uploader was built from:
        # the blocked sweeps pass the same reference row object for
        # every staged super-row, and rebuilding the uploader per
        # prepare() would re-upload the ref row each time
        self._diff_ref_src = None
        # Reference row on device for rel packing (set by prepare)
        self.rel_ref = None
        # Consecutive narrow-pack saturations; past the sticky limit the
        # engine escalates to rel packing (same wire size as narrow but
        # diversity-independent), or wide when rel is unavailable or
        # itself saturating — diverse data overflows the 8-bit lanes
        # every time, and paying narrow + wide + an extra round trip per
        # block is strictly worse than the next rung alone.
        self._overflow_streak = 0
        self._rel_overflow_streak = 0
        self._rel4_overflow_streak = 0
        # Retargeting of the stream diff reference (see dispatch_stream):
        # whenever the current reference cannot compress a batch, the
        # engine re-aims it at that batch's own per-column mode — covers
        # a stream from a different lineage than the loaded set AND
        # slowly-drifting streams whose early reference goes stale.
        # Consecutive retargets that still fail to compress stop the
        # probing (a genuinely diverse stream never wins).
        import threading

        self._retarget_fail_streak = 0
        self._retarget_lock = threading.Lock()
        # Persistent g-side feature cache (id(dev) -> (dev, gfeat)) and
        # the rel reference row's feature pair; see _jit_block_fn_feat.
        # Sharded engines cache too — the g tensor is built
        # block-partitioned (R, nb, tj, l_pad) so block slices stay
        # shard-local under the "dp" column partition.
        self.feat_cache_on = backend == "xla" and _featcache_budget() > 0
        self._gcache: Dict[int, tuple] = {}
        self._fcache: Dict[int, tuple] = {}
        self.rel_ref_f = None
        self.rel_ref_g = None

    def prepare(self, matrix: np.ndarray, max_block: int,
                row_tile: Optional[int] = None,
                diff_ref: Optional[np.ndarray] = None,
                cache_g: bool = True, cache_f: bool = False,
                h2d_memo: Optional[dict] = None) -> object:
        """Pad and (for device backends) upload a sequence matrix.

        ``max_block`` is the largest tile size whose slices must stay in
        bounds; rows are padded so any aligned slice fits.  With
        ``row_tile``, rows are padded to a multiple of it instead (used
        by the out-of-core sweep for super-row staging).  ``diff_ref``
        (a width-length code row) enables diff-encoded uploads against
        that reference for this matrix and later stream dispatches.
        ``h2d_memo``: a per-super-row dict the out-of-core sweeps keep
        across X groups — the first staging stores the diff encoding,
        and every re-staging skips the pad + compare + extract host
        passes, shipping only the cached (idx, vals) diffs.
        """
        n, width = matrix.shape
        if self.backend == "numpy":
            return matrix
        if row_tile is not None:
            n_pad = -(-max(n, 1) // row_tile) * row_tile
        else:
            tile = max_block
            n_strips = max(1, -(-n // self.ti))
            n_pad = (n_strips - 1) * self.ti + max(tile, self.ti)
            n_pad = max(n_pad, tile)
        l_pad = -(-max(width, 1) // 128) * 128
        import jax
        import jax.numpy as jnp

        padded = None

        def _padded() -> np.ndarray:
            nonlocal padded
            if padded is None:
                padded = np.zeros((n_pad, l_pad), dtype=np.uint8)
                padded[:n, :width] = matrix
            return padded

        if diff_ref is not None and not (
            self.diff_up is not None
            and self._diff_ref_src is diff_ref
            and self.diff_up.l_pad == l_pad
        ):
            from distance_tpu.ops.diffup import DiffUploader

            refp = np.zeros(l_pad, dtype=np.uint8)
            refp[:width] = diff_ref
            # sharded engines diff-encode too: the scatter rebuild runs
            # under pjit with a mesh-replicated output (the dense sharded
            # upload's placement), so multi-chip runs ship (idx, code)
            # diffs instead of the dense matrix, as single-device runs do
            self.diff_up = DiffUploader(refp, sharded=self.sharded)
            self._diff_ref_src = diff_ref
        if self.diff_up is not None:
            # memo validity: same uploader (a stream retarget swaps it)
            # and same padded shape
            if (
                h2d_memo is not None
                and h2d_memo.get("up") is self.diff_up
                and h2d_memo.get("n_pad") == n_pad
            ):
                enc = h2d_memo["enc"]
            else:
                enc = self.diff_up.encode(_padded(), n_real=n)
                if h2d_memo is not None:
                    h2d_memo.clear()
                    h2d_memo.update(
                        up=self.diff_up, n_pad=n_pad, enc=enc
                    )
            if enc is not None:
                dev = self.diff_up.upload_encoded(enc, n_pad)
            elif self.sharded:
                dev = _replicated_put(_padded(), self.tj)
            else:
                dev = _chunked_h2d(_padded())
        elif self.sharded:
            dev = _replicated_put(_padded(), self.tj)
        else:
            dev = _chunked_h2d(_padded())
        # Reference row for rel packing: reuse the diff-upload reference
        # when present, else the per-column mode of a row sample.  Rel
        # residuals are width-independent (they accrue only on columns
        # where both records diverge from the reference), so this is NOT
        # gated on self.packed: at unpacked widths (>= 2^16 sites) rel is
        # the only sub-int32 wire format available (4x smaller).
        if (
            self.backend == "xla" and width > 0 and n
            and not _os.environ.get("DISTANCE_TPU_NO_REL_PACK")
        ):
            if self.diff_up is not None:
                self.rel_ref = self.diff_up.ref_dev()
            else:
                from distance_tpu.ops.diffup import sampled_mode_row

                refp = np.zeros(l_pad, dtype=np.uint8)
                refp[:width] = sampled_mode_row(matrix)
                if self.sharded:
                    self.rel_ref = _replicated_put(refp, self.tj)
                else:
                    self.rel_ref = jnp.asarray(refp)
        # Persistent g-side feature cache: build (R, n_pad, l_pad) int8
        # once so block dispatches contract cached slices instead of
        # rematerializing the whole matrix's features every strip (the
        # column side dominates the per-block feature cost at tj > ti).
        # Engagement respects BOTH budgets: the featcache budget caps the
        # cache tensor itself, and — for FULL-matrix prepares (row_tile
        # is None) — cache + codes must also fit the HBM sequence-data
        # budget.  Without the second check, a 14-channel cache that
        # squeaks under the featcache budget can exhaust device memory
        # once codes + builder temporaries land on top.  Staged prepares (row_tile set) are exempt: the blocked sweeps
        # size their super-rows to ~budget/3 with (1 + channels)-row
        # accounting already, and their tile-size floor must stage (and
        # may cache) at least one tile regardless of a forced budget.
        cache_need = self.plan.total_channels * n_pad * l_pad
        # Sharded engines build the g cache with the BLOCKED builder,
        # which pads rows up to a tj multiple (_jit_feat_builder_blocked)
        # — account those extra rows or an exact-fit engagement can OOM
        # at ti != tj (up to channels x (tj-1) x l_pad under-count).
        g_need = cache_need
        if self.sharded:
            g_need = (
                self.plan.total_channels
                * (-(-n_pad // self.tj) * self.tj) * l_pad
            )
        mat_bytes = n_pad * l_pad
        hbm_ok = (
            row_tile is not None
            or g_need + mat_bytes <= _hbm_budget()
        )
        g_engaged = (
            self.feat_cache_on and cache_g
            and g_need <= _featcache_budget()
            and hbm_ok
        )
        if g_engaged:
            if self.sharded:
                gfeat = _jit_feat_builder_blocked(self.measure, self.tj)(dev)
            else:
                gfeat = _jit_feat_builder(self.measure, "g")(dev)
            self._gcache[id(dev)] = (dev, gfeat)
        if (
            self.feat_cache_on and cache_f
            and cache_need <= _featcache_budget() // 2
            and (
                row_tile is not None
                or cache_need + (g_need if g_engaged else 0) + mat_bytes
                <= _hbm_budget()
            )
        ):
            # f-side cache: the out-of-core sweep re-dispatches the same
            # X strip against every Y super-row, so per-strip f-feature
            # builds repeat n/sr_rows times without it
            ffeat = _jit_feat_builder(
                self.measure, "f", repl=self.sharded
            )(dev)
            self._fcache[id(dev)] = (dev, ffeat)
        if self.feat_cache_on and self.rel_ref is not None:
            ref2 = self.rel_ref[None, :]
            self.rel_ref_f = _jit_feat_builder(
                self.measure, "f", repl=self.sharded
            )(ref2)
            self.rel_ref_g = _jit_feat_builder(
                self.measure, "g", repl=self.sharded
            )(ref2)
        return dev

    def gfeat_of(self, handle) -> Optional[object]:
        """Cached g-feature tensor for a prepared matrix, or None."""
        entry = self._gcache.get(id(handle))
        return entry[1] if entry is not None else None

    def release(self, handle) -> None:
        """Drop a prepared matrix's feature caches (frees HBM — the
        out-of-core sweep stages matrices through prepare repeatedly)."""
        if handle is not None:
            self._gcache.pop(id(handle), None)
            self._fcache.pop(id(handle), None)

    def fx_strip(self, m1, i0: int, ti: int):
        """f-side features of one strip: a slice of the cached f tensor
        when present, else built from the codes (once per strip)."""
        entry = self._fcache.get(id(m1))
        if entry is not None:
            return _jit_fx_slice(self.measure, ti, repl=self.sharded)(
                entry[1], i0
            )
        return _jit_fx_strip(self.measure, ti, repl=self.sharded)(m1, i0)

    def gcache_usable(self, col_starts) -> bool:
        """Whether the cached-g path can serve these column starts: the
        sharded blocked layout only resolves tj-aligned block lookups
        (misaligned strips fall back to the recomputing path)."""
        if not self.sharded:
            return True
        return all(j0 % self.tj == 0 for j0 in col_starts)

    def block_feat(self, fx, gyf, i0: int, j0: int, ti: int, tj: int,
                   mode: str, nv=None, diag_off=None):
        """Cached-feature block dispatch (see _jit_block_fn_feat)."""
        fn = _jit_block_fn_feat(
            self.measure, ti, tj, mode, self.width,
            diag_mask=(mode in ("rel", "rel4") and diag_off is not None),
            sharded=self.sharded and tj == self.tj,
        )
        if mode in ("rel", "rel4"):
            nv1, nv2 = nv if nv is not None else (gyf.shape[1], gyf.shape[1])
            return fn(fx, gyf, i0, j0, self.rel_ref_f, self.rel_ref_g,
                      np.int32(nv1), np.int32(nv2), np.int32(diag_off or 0))
        return fn(fx, gyf, j0)

    def block(self, m1, m2, i0: int, j0: int, ti: int, tj: int,
              mode: Optional[str] = None, nv=None, diag_off=None):
        """Dispatch one (ti, tj) counter block; returns a lazy handle
        (a raw (lanes, cb, rb_cc[, exc_idx, exc_val]) tuple under rel
        packing — _dispatch_strip fuses the small arrays into a single
        sidecar bundle before fetch).  ``nv`` = (valid rows in m1, valid rows in m2) — the
        rel4 pack zeroes padding cells so they cannot flood the
        exception sidecar.  ``diag_off`` (self-sweeps over one source):
        m1's global row offset minus m2's, for masking self-pair cells;
        None when the two sides cannot contain self-pairs.  Defaults to
        0 when m1 is m2."""
        if self.backend == "numpy":
            x = m1[i0 : i0 + ti]
            y = m2[j0 : j0 + tj]
            return _counters_numpy(x, y, self.plan)
        if mode is None:
            mode = self.pack_mode
        if diag_off is None and m1 is m2:
            diag_off = 0
        fn = _jit_block_fn(self.measure, ti, tj, mode,
                           self.width, self.sharded and tj == self.tj,
                           diag_mask=(mode in ("rel", "rel4")
                                      and diag_off is not None))
        if mode in ("rel", "rel4"):
            nv1, nv2 = nv if nv is not None else (m1.shape[0], m2.shape[0])
            return fn(m1, m2, i0, j0, self.rel_ref,
                      np.int32(nv1), np.int32(nv2),
                      np.int32(diag_off or 0))
        return fn(m1, m2, i0, j0)

    def diff_ref_for(self, source: np.ndarray) -> Optional[np.ndarray]:
        """Reference row for diff-encoded uploads of ``source`` (a row
        sample's per-column mode), or None when diff uploads don't apply
        (numpy backend, or disabled by env).  Sharded engines diff too:
        the scatter rebuild runs under pjit with a replicated output."""
        if self.backend == "numpy" or not source.size:
            return None
        if _os.environ.get("DISTANCE_TPU_NO_DIFF_UPLOAD"):
            return None
        from distance_tpu.ops.diffup import sampled_mode_row

        return sampled_mode_row(source)

    def dispatch_stream(self, m1, padded: np.ndarray, rows_pad: int,
                        mode: Optional[str] = None, nv=None,
                        h2d_cache: Optional[dict] = None):
        """Fused dispatch of one whole stream group: diff rebuild (when
        the batch is low-diversity) + every loaded strip + packing in a
        single jitted call.  Returns a lazy (P, n1_pad, rows_pad) handle
        (a ``(lanes, sidecar-bundle)`` pair for the rel pack modes —
        ops/packing.bundle_sidecars fuses the baselines and the rel4
        exception sidecar into one D2H request).  ``nv`` = (valid loaded
        rows, valid streamed rows).  ``h2d_cache``: a per-group dict the
        staged sweep passes so the group's encode + H2D happen ONCE
        instead of once per loaded super-row (the encode alone is a host
        pass over the whole ~250 MB group)."""
        if mode is None:
            mode = self.stream_pack_mode
        n1_pad, l_pad = m1.shape
        nv1, nv2 = nv if nv is not None else (n1_pad, rows_pad)
        nvs = (np.int32(nv1), np.int32(nv2))
        # Snapshot the uploader: dispatch_stream runs on the dispatcher
        # thread AND on the main thread (redispatch during a saturated
        # refetch), and the retarget below swaps self.diff_up.  Each
        # dispatch stays self-consistent by pairing an encoding with ITS
        # OWN uploader's reference (the fused fn's single ref argument is
        # both the scatter rebuild base and the rel baseline row; rel
        # unpack is exact for any ref since baselines travel with the
        # fetch).
        if h2d_cache is not None and "up_enc" in h2d_cache:
            up, enc = h2d_cache["up_enc"]
            return self._dispatch_stream_enc(
                m1, padded, rows_pad, mode, nvs, up, enc, h2d_cache
            )
        up = self.diff_up
        enc = up.encode(padded, n_real=int(nv2)) if up is not None else None
        if enc is None and up is not None:
            # The current reference rejected this batch, but streamed
            # records often share ancestry with EACH OTHER (a stream
            # from a different lineage than the loaded set, or one that
            # drifted away from an earlier reference): retarget the diff
            # reference to this batch's own per-column mode.  After
            # RETARGET_FAIL_LIMIT consecutive candidates that also fail
            # to compress, stop probing — the stream is just diverse.
            with self._retarget_lock:
                probe = self._retarget_fail_streak < RETARGET_FAIL_LIMIT
            if probe:
                # The probe itself (mode-row scan + a second encode over
                # a ~250 MB group) runs UNLOCKED: dispatch_stream also
                # runs on the main thread during saturated-refetch
                # redispatch, which must not stall behind it.  Only the
                # streak update and the uploader swap take the lock;
                # concurrent probes at worst duplicate work.
                from distance_tpu.ops.diffup import (
                    DiffUploader, sampled_mode_row,
                )

                refp = np.zeros(l_pad, dtype=np.uint8)
                refp[:] = sampled_mode_row(padded[: int(nv2)])
                refp[self.width:] = 0  # keep pad columns zero
                cand = DiffUploader(refp, sharded=self.sharded)
                enc2 = cand.encode(padded, n_real=int(nv2))
                if enc2 is not None:
                    cand.ref_dev()  # upload before publishing
                with self._retarget_lock:
                    if enc2 is not None:
                        self._retarget_fail_streak = 0
                        self.diff_up = cand  # later groups start here
                        self.rel_ref = cand.ref_dev()
                    else:
                        self._retarget_fail_streak += 1
                if enc2 is not None:
                    up, enc = cand, enc2
        if h2d_cache is not None:
            if enc is not None:
                # device-put the diff encoding once so every super-row
                # dispatch reuses the same device arrays
                import jax.numpy as jnp

                enc = (jnp.asarray(enc[0]), jnp.asarray(enc[1]))
            h2d_cache["up_enc"] = (up, enc)
        return self._dispatch_stream_enc(
            m1, padded, rows_pad, mode, nvs, up, enc, h2d_cache
        )

    def _dispatch_stream_enc(self, m1, padded: np.ndarray, rows_pad: int,
                             mode: str, nvs, up, enc, h2d_cache):
        """Dispatch one stream group against ``m1`` with an
        already-resolved (uploader, encoding) pair — the tail of
        dispatch_stream, factored so the staged sweep can reuse the
        group's encode/H2D across loaded super-rows."""
        n1_pad, l_pad = m1.shape
        if enc is None:
            fn = _jit_stream_fn(
                self.measure, self.ti, rows_pad, n1_pad,
                mode, self.width, l_pad, None, self.sharded,
            )
            dense = (
                h2d_cache.get("dense") if h2d_cache is not None else None
            )
            if dense is None:
                dense = _chunked_h2d(padded)
                if h2d_cache is not None:
                    h2d_cache["dense"] = dense
            if mode in ("rel", "rel4"):
                # dense path: the ref is only the rel baseline row — any
                # reference is exact; use the uploader's when present so
                # ref reuse keeps the jit executable warm
                ref = up.ref_dev() if up is not None else self.rel_ref
                return fn(m1, ref, dense, *nvs)
            return fn(m1, dense)
        idx, vals = enc
        fn = _jit_stream_fn(
            self.measure, self.ti, rows_pad, n1_pad,
            mode, self.width, l_pad, int(idx.shape[0]), self.sharded,
        )
        return fn(m1, up.ref_dev(), idx, vals, *nvs)

    @property
    def _rel_usable(self) -> bool:
        return (
            self.rel_ref is not None
            and self._rel_overflow_streak < NARROW_STICKY_LIMIT
        )

    @property
    def _rel4_usable(self) -> bool:
        return (
            self.rel_ref is not None
            and self._rel4_shard_ok
            and self._rel4_overflow_streak < NARROW_STICKY_LIMIT
        )

    @property
    def pack_mode(self) -> str:
        """Escalation ladder: rel4 (4-bit residuals, half of every other
        rung's bytes) -> (saturations) -> rel -> (saturations) ->
        narrow/wide (packed widths) or none (>= 2^16 sites, where 16-bit
        lanes can't hold the counters).  Without a reference row the
        ladder is the historical narrow -> (saturations) -> wide."""
        if self.backend == "numpy":
            return "none"
        if self._rel4_usable:
            return "rel4"
        if self._rel_usable:
            return "rel"
        if not self.packed:
            return "none"
        if self._overflow_streak >= NARROW_STICKY_LIMIT:
            return "wide"
        return "narrow"

    @property
    def stream_pack_mode(self) -> str:
        """Pack mode for stream-group dispatches (same ladder; rel rungs
        are diversity-independent and narrow-or-better in bytes)."""
        return self.pack_mode

    def note_narrow(self, overflowed: bool) -> None:
        """Record a narrow-fetch outcome (drives the sticky escalation)."""
        self._overflow_streak = self._overflow_streak + 1 if overflowed else 0

    def note_rel(self, saturated: bool) -> None:
        self._rel_overflow_streak = (
            self._rel_overflow_streak + 1 if saturated else 0
        )

    def note_rel4(self, saturated: bool) -> None:
        self._rel4_overflow_streak = (
            self._rel4_overflow_streak + 1 if saturated else 0
        )

    def to_host(self, handle):
        """Synchronously materialize a dispatched block on host (used for
        warm-up; emission paths go through the strip fetch helpers).
        rel-family handles are tuples of device arrays."""
        if isinstance(handle, tuple):
            return tuple(np.asarray(h) for h in handle)
        return np.asarray(handle)


# ---------------------------------------------------------------------------
# In-memory sweeps
# ---------------------------------------------------------------------------

def _emit_pairs(
    setup: Setup,
    aln1: Alignment,
    aln2: Alignment,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    counters: Dict[str, np.ndarray],
    same_offset: int = 0,
    emitter=None,
    after=None,
    pool: Optional[_ScratchPool] = None,
    lease: Optional[List[np.ndarray]] = None,
) -> None:
    """Finalize + write one flat batch of pairs (already in order).

    ``same_offset`` re-adds exact-base invariant columns dropped by
    column pruning (they contribute +1 to ``same``/``kk`` per pair and
    nothing to any other counter).  With an ``emitter``, the formatting/
    write tail (plus the ``after`` callback — progress checkpointing)
    runs on the ordered writer thread, overlapped with the next strip.
    tn93's per-pair base tallies are never materialized: the native
    finalizer gathers rows from the per-sequence tables using the same
    index arrays that drive id emission.
    """
    if same_offset:
        for key in ("same", "kk"):
            arr = counters.get(key)
            if arr is None:
                continue
            if arr.flags.writeable:
                # in place: these are this emission's own gather/lease
                # buffers, and a fresh multi-GB array per strip is
                # exactly what the scratch pool exists to avoid
                np.add(arr, same_offset, out=arr)
            else:
                counters[key] = arr + same_offset
    bc = None
    if setup.measure == "tn93":
        bc = (aln1.base_counts, pair_i, aln2.base_counts, pair_j)
    with phase_timer("keys"):
        if (
            setup.measure == "tn93"
            and aln1.base_counts is not None
            and aln2.base_counts is not None
        ):
            keys, keyspace = _tn93_value_keys(
                counters, aln1.tally_ranks(), pair_i,
                aln2.tally_ranks(), pair_j, pool, lease,
            )
        else:
            keys, keyspace = _value_keys(setup.measure, counters,
                                         aln1.width, pool, lease)
    if keys is not None:
        # Memoized tail: the writer ranks the keys and calls back with
        # one representative row per DISTINCT key — finalize runs over
        # thousands of rows instead of millions (the f64 logs and the
        # per-pair value array both vanish from the hot path).  Equal
        # keys imply equal counters (and, for tn93, equal tally rows)
        # imply bit-identical values, so any representative is exact.
        measure = setup.measure

        def values(first_rows: Optional[np.ndarray]) -> np.ndarray:
            if first_rows is None:
                with phase_timer("finalize"):
                    return finalize_block(measure, counters, bc)
            sub = {k: v[first_rows] for k, v in counters.items()}
            sbc = None
            if bc is not None:
                bcq, iq, bct, it = bc
                sbc = (bcq, iq[first_rows], bct, it[first_rows])
            with phase_timer("finalize"):
                return finalize_block(measure, sub, sbc)
    else:
        out = None
        if (
            pool is not None and lease is not None
            and setup.measure not in ("n", "n_high")
        ):
            n_rows = next(iter(counters.values())).shape[0]
            out = pool.take(n_rows, np.float64, lease)
        with phase_timer("finalize"):
            values = finalize_block(setup.measure, counters, bc, out=out)

    def tail() -> None:
        with phase_timer("write"):
            setup.writer.rows(
                aln1.ids, aln2.ids, pair_i, pair_j, values, keys, keyspace
            )
        if after is not None:
            after()
        if pool is not None and lease:
            pool.give_all(lease)

    if emitter is None:
        tail()
    else:
        emitter.submit(tail)


# Upper bound on the memo keyspace: the writer's rank table is one int32
# per key (dt_key_rank), so 2^26 caps it at 256 MB — far above any
# realistic tight packing (see _value_keys), present only as a backstop
# against adversarial counter spreads.
_KEYSPACE_CAP = 1 << 26


def _lin3_native(lib, out, a, b, c, ca, cb, cc, c0):
    """Parallel out = ca*a + cb*b (+ cc*c) + c0 over int32 arrays."""
    import ctypes

    from distance_tpu.finalize import _get_pool

    p32 = ctypes.POINTER(ctypes.c_int32)
    n = out.shape[0]
    step = max(1 << 21, -(-n // 8))

    def run(lo):
        hi = min(lo + step, n)
        lib.dt_keys_lin3(
            a[lo:hi].ctypes.data_as(p32), b[lo:hi].ctypes.data_as(p32),
            c[lo:hi].ctypes.data_as(p32) if c is not None else None,
            hi - lo, ca, cb, cc, c0, out[lo:hi].ctypes.data_as(p32),
        )

    futs = [_get_pool().submit(run, lo) for lo in range(0, n, step)]
    for f in futs:
        f.result()


def _minmax_native(lib, a):
    import ctypes

    mn = ctypes.c_int32()
    mx = ctypes.c_int32()
    lib.dt_minmax_i32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 0, a.shape[0],
        ctypes.byref(mn), ctypes.byref(mx),
    )
    return mn.value, mx.value


def _value_keys(measure: str, counters: Dict[str, np.ndarray], width: int,
                pool: Optional[_ScratchPool] = None, lease=None):
    """Per-pair integer keys that determine the finalized value.

    A pair's distance is a pure function of its counters (plus the
    constant alignment width); packing them into a small key lets the
    writer finalize + format each DISTINCT value once (sort-free
    memoization).  Packing is tight — mixed-radix over the counters'
    actual maxima — because realistic ambiguity loads (~150 N/gap sites
    per record -> pair nonsame ~300) overflow any fixed 8-bit field; the
    round-2 static packing silently disabled the memo for raw/jc69/k80
    on exactly the data it was built for.  tn93 is excluded — its value
    also depends on the pair's base tallies.

    Every keyed measure's key is LINEAR in its counters given width, so
    the native path builds keys in one fused parallel pass
    (dt_keys_lin3) instead of a chain of numpy temporaries (~2.5 s ->
    ~0.3 s per 74 M-pair strip measured on the 4-core bench host).
    """
    from distance_tpu._native import get_lib

    lib = get_lib()

    def scratch(n):
        if pool is not None and lease is not None:
            return pool.take(n, np.int32, lease)
        return np.empty(n, dtype=np.int32)

    if measure in ("n", "n_high"):
        d = counters["diff"]
        if not d.size:
            return None, 0
        dm = int(d.max(initial=0))
        if dm >= _KEYSPACE_CAP:
            return None, 0
        return np.asarray(d, dtype=np.int32), dm + 1
    native = (
        lib is not None
        and all(
            v.dtype == np.int32 and v.flags.c_contiguous
            for v in counters.values()
        )
    )
    if measure in ("raw", "jc69"):
        d, same = counters["diff"], counters["same"]
        if not d.size:
            return None, 0
        if native:
            nsum = scratch(d.shape[0])
            _lin3_native(lib, nsum, d, same, None, 1, 1, 0, 0)
            s_mn, s_mx = _minmax_native(lib, nsum)
            _, d_mx = _minmax_native(lib, d)
            if s_mx > width:  # negative nonsame somewhere
                return None, 0
            nm = width - s_mn + 1
            if (d_mx + 1) * nm > _KEYSPACE_CAP:
                return None, 0
            keys = nsum  # reuse the buffer: keys = nm*d - nsum + width
            _lin3_native(lib, keys, d, nsum, None, nm, -1, 0, width)
            return keys, (d_mx + 1) * nm
        nonsame = width - (same + d)
        if int(nonsame.min(initial=0)) < 0:
            return None, 0
        dm = int(d.max(initial=0)) + 1
        nm = int(nonsame.max(initial=0)) + 1
        if dm * nm > _KEYSPACE_CAP:
            return None, 0
        return (d * np.int32(nm) + nonsame).astype(np.int32), dm * nm
    if measure == "k80":
        same, ts, tv = counters["same"], counters["ts"], counters["tv"]
        if not ts.size:
            return None, 0
        if native:
            nsum = scratch(ts.shape[0])
            _lin3_native(lib, nsum, same, ts, tv, 1, 1, 1, 0)
            s_mn, s_mx = _minmax_native(lib, nsum)
            _, t_mx = _minmax_native(lib, ts)
            _, v_mx = _minmax_native(lib, tv)
            if s_mx > width:
                return None, 0
            tm, vm, lm = t_mx + 1, v_mx + 1, width - s_mn + 1
            if tm * vm * lm > _KEYSPACE_CAP:
                return None, 0
            # key = (W - nsum)*tm*vm + ts*vm + tv
            keys = nsum
            _lin3_native(lib, keys, ts, tv, nsum, vm, 1, -tm * vm,
                         width * tm * vm)
            return keys, tm * vm * lm
        nonl = width - (same + ts + tv)
        if int(nonl.min(initial=0)) < 0:
            return None, 0
        tm = int(ts.max(initial=0)) + 1
        vm = int(tv.max(initial=0)) + 1
        lm = int(nonl.max(initial=0)) + 1
        if tm * vm * lm > _KEYSPACE_CAP:
            return None, 0
        keys = (nonl * np.int32(tm) + ts) * np.int32(vm) + tv
        return keys.astype(np.int32), tm * vm * lm
    return None, 0


def _tn93_value_keys(counters: Dict[str, np.ndarray], rq, pair_i, rt,
                     pair_j, pool: Optional[_ScratchPool] = None,
                     lease=None):
    """tn93 memo keys: (counter key, tally-rank-q, tally-rank-t).

    tn93's value is a pure function of (kk, kk - same, p1, p2) and the
    pairwise tally SUM (finalize_tn93, measures.rs:116-193) — equal
    per-side tally rows imply an equal sum, so distinct tally rows
    ranked once per side (Alignment.tally_ranks) make the value keyable.
    When counter-space x Rq x Rt fits _KEYSPACE_CAP the key is dense
    (mixed radix); beyond that a native hash-rank pass
    (dt_keys_hashrank_slots, chunked across the pool) densifies the
    OCCURRING combinations — on
    duplicate-heavy real datasets (identical records => identical
    tallies) those are few even when the product space is astronomical.
    The maximal-diversity worst case (every record a distinct tally)
    bails inside the hash pass the moment distinct keys exceed the
    budget, at a bounded partial-pass cost.

    ``rq``/``rt``: (rank int32 array indexed by pair_i/pair_j, cardinality).
    """
    from distance_tpu._native import get_lib

    lib = get_lib()
    rank_q, rq_card = rq
    rank_t, rt_card = rt
    kk, same = counters["kk"], counters["same"]
    p1, p2 = counters["p1"], counters["p2"]
    n = kk.shape[0]
    if not n:
        return None, 0

    def scratch(m):
        if pool is not None and lease is not None:
            return pool.take(m, np.int32, lease)
        return np.empty(m, dtype=np.int32)

    native = (
        lib is not None
        and all(
            v.dtype == np.int32 and v.flags.c_contiguous
            for v in (kk, same, p1, p2, pair_i, pair_j, rank_q, rank_t)
        )
    )
    if native:
        d = scratch(n)
        _lin3_native(lib, d, kk, same, None, 1, -1, 0, 0)
        kk_mn, kk_mx = _minmax_native(lib, kk)
        d_mn, d_mx = _minmax_native(lib, d)
        p1_mn, p1_mx = _minmax_native(lib, p1)
        p2_mn, p2_mx = _minmax_native(lib, p2)
    else:
        d = (kk - same).astype(np.int32)
        kk_mn, kk_mx = int(kk.min()), int(kk.max())
        d_mn, d_mx = int(d.min()), int(d.max())
        p1_mn, p1_mx = int(p1.min()), int(p1.max())
        p2_mn, p2_mx = int(p2.min()), int(p2.max())
    km = kk_mx - kk_mn + 1
    dm = d_mx - d_mn + 1
    p1m = p1_mx - p1_mn + 1
    p2m = p2_mx - p2_mn + 1
    cspace = km * dm * p1m * p2m
    keyspace = cspace * rq_card * rt_card
    dense = keyspace <= _KEYSPACE_CAP
    if not dense and (
        not native or keyspace > (1 << 62) or cspace > (1 << 31)
    ):
        # the hash path needs the native lib, a 64-bit combined key, and
        # a counter key that fits int32 (keyc is built by dt_keys_lin3
        # into an int32 buffer; cspace beyond 2^31 would truncate it and
        # collide DISTINCT counter tuples onto one memo key — silently
        # wrong values).  Spreads that wide mean maximal diversity,
        # where the memo would not pay anyway.
        return None, 0
    # key_c = ((kk-kk_mn)*dm + (d-d_mn))*p1m*p2m + (p1-p1_mn)*p2m + (p2-p2_mn)
    a_co = dm * p1m * p2m
    b_co = p1m * p2m
    c0 = -(kk_mn * a_co + d_mn * b_co + p1_mn * p2m + p2_mn)
    if native:
        import ctypes

        t = scratch(n)
        _lin3_native(lib, t, kk, d, None, a_co, b_co, 0, c0)
        keyc = d  # reuse: d is consumed
        _lin3_native(lib, keyc, p1, p2, t, p2m, 1, 1, 0)
        keys = t  # reuse
        p32 = ctypes.POINTER(ctypes.c_int32)
        if dense:
            lib.dt_keys_rank2(
                keyc.ctypes.data_as(p32), pair_i.ctypes.data_as(p32),
                pair_j.ctypes.data_as(p32), rank_q.ctypes.data_as(p32),
                rank_t.ctypes.data_as(p32), n, rq_card, rt_card,
                keys.ctypes.data_as(p32),
            )
            return keys, keyspace
        # Hash-rank: the dense product space is too large, but the
        # OCCURRING combinations may be few (duplicate-heavy data).
        # Produces already-dense keys, so the writer's rank table is
        # exactly n_distinct; bails the moment distinct keys exceed the
        # budget (memo would not pay), costing a bounded partial pass.
        # Three phases so the row passes parallelize (the serial
        # single-pass version measured 5.2 s at 401 M rows): (1) chunks
        # CAS-claim slots in a shared table, out = slot index; (2) the
        # <= 2^20 occupied slots rank in ascending-key order (numpy,
        # deterministic regardless of racy slot placement); (3) chunks
        # map slot -> rank in place.
        max_distinct = min(1 << 20, max(1024, n // 4))
        table_bits = max(12, (2 * max_distinct - 1).bit_length())
        tsize = 1 << table_bits
        key_tab = np.full(tsize, -1, dtype=np.int64)
        nd_ctr = np.zeros(1, dtype=np.int64)
        p64 = ctypes.POINTER(ctypes.c_int64)
        from distance_tpu.finalize import _get_pool

        tpool = _get_pool()
        step = max(1 << 21, -(-n // max(1, tpool._max_workers)))

        def run1(lo, hi):
            return lib.dt_keys_hashrank_slots(
                keyc.ctypes.data_as(p32), pair_i.ctypes.data_as(p32),
                pair_j.ctypes.data_as(p32), rank_q.ctypes.data_as(p32),
                rank_t.ctypes.data_as(p32), lo, hi, rq_card, rt_card,
                key_tab.ctypes.data_as(p64), table_bits, max_distinct,
                nd_ctr.ctypes.data_as(p64), keys.ctypes.data_as(p32),
            )

        futs = [
            tpool.submit(run1, lo, min(lo + step, n))
            for lo in range(0, n, step)
        ]
        # await EVERY chunk before deciding: a short-circuit on the
        # first overflow would return (and later recycle the pool lease
        # backing `keys`) while straggler chunks are still writing into
        # it — cross-strip buffer corruption
        if any(r < 0 for r in [f.result() for f in futs]):
            return None, 0
        nd = int(nd_ctr[0])
        occ = np.flatnonzero(key_tab != -1)
        rank_tab = np.empty(tsize, dtype=np.int32)
        rank_tab[occ[np.argsort(key_tab[occ])]] = np.arange(
            nd, dtype=np.int32
        )

        def run3(lo, hi):
            lib.dt_map_i32(
                rank_tab.ctypes.data_as(p32), lo, hi,
                keys.ctypes.data_as(p32),
            )

        futs = [
            tpool.submit(run3, lo, min(lo + step, n))
            for lo in range(0, n, step)
        ]
        for f in futs:
            f.result()
        return keys, nd
    keyc = (
        (kk.astype(np.int64) - kk_mn) * a_co + (d.astype(np.int64) - d_mn) * b_co
        + (p1.astype(np.int64) - p1_mn) * p2m + (p2.astype(np.int64) - p2_mn)
    )
    keys = (
        keyc * (rq_card * rt_card)
        + rank_q[pair_i].astype(np.int64) * rt_card + rank_t[pair_j]
    )
    return keys.astype(np.int32), keyspace


def _tri_indices(si: int, i0: int, n: int):
    """Vectorized emission indices for one square-mode strip.

    Rows i0..i0+si-1; row i emits columns i+1..n.  Returns
    (local_rows int32, col_idx int32) in canonical (row-major) order.
    """
    rows = np.arange(si, dtype=np.int64)
    counts = np.maximum(n - (i0 + rows) - 1, 0)
    total = int(counts.sum())
    local_rows = np.repeat(np.arange(si, dtype=np.int32), counts)
    # concatenated ranges [i+1, n): global position minus the start of
    # this row's run, plus the row's first column (fused int32 — the
    # widened-int64 form of this arithmetic is ~100x slower)
    starts = np.zeros(si, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    first_col = i0 + rows + 1
    col_idx = np.arange(total, dtype=np.int32) - np.repeat(
        (starts - first_col).astype(np.int32), counts
    )
    return local_rows, col_idx


class _ScratchPool:
    """Recycled large scratch arrays for the emission tail.

    Strips allocate multi-GB gather/key/index buffers; on VM hosts with
    lazy guest-memory faulting (measured here: first-touch 1.8 GB/s vs
    5.9 GB/s warm, with DAMON reclaim re-chilling freed pages) fresh
    allocations per strip dominate the tail.  The pool hands back the
    previous strip's buffers instead — square-mode strips shrink
    monotonically, so the first strip's buffers fit all later ones.
    take() is called on the producing thread, give() by the emitter
    thread after the rows are written.
    """

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._free: Dict[str, List[np.ndarray]] = {}

    def take(self, n: int, dtype, lease: List[np.ndarray]) -> np.ndarray:
        """A 1-D array of ``n`` elements; its backing root is appended to
        ``lease`` for give_all() once the consumer is done with it."""
        key = np.dtype(dtype).str
        root = None
        with self._lock:
            lst = self._free.get(key)
            if lst:
                for k, arr in enumerate(lst):
                    if arr.shape[0] >= n:
                        root = lst.pop(k)
                        break
        if root is None:
            root = np.empty(n, dtype=dtype)
        lease.append(root)
        return root[:n]

    def give_all(self, lease: List[np.ndarray]) -> None:
        with self._lock:
            for root in lease:
                self._free.setdefault(root.dtype.str, []).append(root)
        lease.clear()


def _gather_emit(strip: np.ndarray, si: int, i0: int, n: int, col0: int,
                 pool: Optional[_ScratchPool] = None, lease=None,
                 tri: bool = True):
    """Fused gather + emission-index build for one strip.

    ``tri``: square-mode upper triangle (row li emits columns > i0+li);
    False emits full rows (rectangle / two-file mode, hi = n - col0
    columns each).  Returns (counter_rows, pair_i, col_idx) —
    counter_rows[g] is the g-th counter gathered over the emitted region
    in canonical row-major order, pair_i/col_idx the absolute emission
    indices — or None when the strip emits nothing.  One parallel native
    pass (dt_gather_strip_tri, rows chunked over the shared pool)
    replaces the numpy repeat/arange index build plus per-row slice
    concatenation that was the measured main-thread bottleneck of the
    emission tail; falls back to exactly those numpy helpers without the
    native lib.
    """
    from distance_tpu._native import get_lib

    lib = get_lib()
    G = strip.shape[0]
    hi = n - col0
    # only the column axis must be unit-stride; counter-plane and row
    # axes may be strided (cropped fetch views, out-of-core buffers)
    plain = strip.size and strip.strides[2] == 4
    if lib is None or not plain:
        if tri:
            local_rows, col_idx = _tri_indices(si, i0, n)
            if col_idx.size == 0:
                return None
            gathered = _gather_strip_triangle(strip, si, i0, n, col0)
            return [gathered[g] for g in range(G)], (
                local_rows + np.int32(i0)
            ), col_idx
        if hi <= 0 or si == 0:
            return None
        local_rows = np.repeat(np.arange(si, dtype=np.int32), hi)
        col_idx = np.tile(
            np.arange(col0, col0 + hi, dtype=np.int32), si
        )
        rows_c = [
            np.ascontiguousarray(strip[g, :si, :hi]).reshape(-1)
            for g in range(G)
        ]
        return rows_c, local_rows + np.int32(i0), col_idx
    import ctypes

    rows = np.arange(si, dtype=np.int64)
    if tri:
        lens = np.maximum(hi - np.maximum(i0 + rows + 1 - col0, 0), 0)
    else:
        lens = np.full(si, max(hi, 0), dtype=np.int64)
    starts = np.zeros(si + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    if total == 0:
        return None
    if pool is not None and lease is not None:
        outc = pool.take(G * total, np.int32, lease).reshape(G, total)
        pair_i = pool.take(total, np.int32, lease)
        col_idx = pool.take(total, np.int32, lease)
    else:
        outc = np.empty((G, total), dtype=np.int32)
        pair_i = np.empty(total, dtype=np.int32)
        col_idx = np.empty(total, dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    args = (
        strip.ctypes.data_as(p_i32), G, strip.strides[0] // 4,
        strip.strides[1] // 4, hi, i0, col0,
        starts.ctypes.data_as(p_i64), total,
    )
    outs = (
        outc.ctypes.data_as(p_i32), pair_i.ctypes.data_as(p_i32),
        col_idx.ctypes.data_as(p_i32),
    )
    from distance_tpu.finalize import _get_pool

    tpool = _get_pool()
    n_chunks = min(8, max(1, total // (1 << 21)))
    # balanced row ranges: boundaries where the pair prefix crosses k/n
    bounds = np.searchsorted(
        starts, np.linspace(0, total, n_chunks + 1)
    ).astype(np.int64)
    bounds[0], bounds[-1] = 0, si
    futs = [
        tpool.submit(lib.dt_gather_strip_tri, *args,
                     int(bounds[k]), int(bounds[k + 1]), *outs,
                     int(tri))
        for k in range(n_chunks)
        if bounds[k] < bounds[k + 1]
    ]
    for f in futs:
        f.result()
    return [outc[g] for g in range(G)], pair_i, col_idx


def _gather_strip_triangle(strip: np.ndarray, si: int, i0: int, n: int,
                           col0: int) -> Dict[int, np.ndarray]:
    """Gather the emitted (i < j) region of a (G, si, cols) strip whose
    column axis starts at absolute column ``col0``.

    Row li covers absolute columns i0+li+1 .. n-1; each row's region is
    CONTIGUOUS in the strip, so this concatenates slices (memcpy speed)
    instead of fancy-indexing ~0.12 us/pair.
    """
    out = {}
    for k in range(strip.shape[0]):
        parts = [
            strip[k, li, i0 + li + 1 - col0 : n - col0] for li in range(si)
        ]
        out[k] = (
            np.concatenate(parts) if len(parts) > 1
            else parts[0].copy() if parts else np.empty(0, strip.dtype)
        )
    return out


# Prune when at least this fraction of columns is invariant.
PRUNE_MIN_FRACTION = 0.25


class _StreamSplit:
    """Variant/invariant column split for stream mode.

    Every counter is a columnwise sum of per-code-pair weights
    W_k(a, b) (ops/features.reference_counter_matrix).  A column where
    every LOADED row holds one code ``a`` contributes W_k(a, b_r) to
    each pair of streamed record r — independent of the loaded row — so
    the device sweep runs over the variant columns only, and each
    record's invariant contribution is restored as a per-record counter
    offset computed from one small code-pair histogram (native
    dt_code_hist, one pass over the record's bytes).  Exactness is
    unconditional; wire bytes and GEMM work shrink by the invariant
    fraction.  This is the streamed-path analog of the reference's
    consensus-difference sparsification (measures.rs:28-53) and of the
    loaded-path invariant-column pruning above.
    """

    def __init__(self, matrix: np.ndarray, plan: CounterPlan):
        from distance_tpu.encoding import ALL_CODES
        from distance_tpu.ops.features import reference_counter_matrix

        first = matrix[0:1]
        inv = (matrix == first).all(axis=0) if matrix.size else (
            np.zeros(matrix.shape[1], dtype=bool)
        )
        self.frac = float(inv.mean()) if inv.size else 0.0
        if inv.size and inv.all():
            # keep one column on-device so the block engine always has a
            # non-empty matrix (identical loaded rows edge case)
            inv = inv.copy()
            inv[0] = False
        self.keep = ~inv
        nc = len(ALL_CODES)
        # bins: (code a, code b) pairs row-major, plus one sentinel row
        # absorbing variant columns (ignored by the zero weight tail)
        self.nbins = nc * nc + nc
        idx_lut = np.zeros(256, dtype=np.uint8)
        idx_lut[ALL_CODES] = np.arange(nc, dtype=np.uint8)
        self.idx_lut = idx_lut
        colkey = np.full(matrix.shape[1], nc * nc, dtype=np.int16)
        colkey[inv] = idx_lut[first[0][inv]].astype(np.int16) * nc
        self.colkey = np.ascontiguousarray(colkey)
        self.wflat = {}
        for name in plan.counters:
            w = reference_counter_matrix(name)[
                np.ix_(ALL_CODES, ALL_CODES)
            ].astype(np.int32)
            flat = np.zeros(self.nbins, dtype=np.int32)
            flat[: nc * nc] = w.reshape(-1)
            self.wflat[name] = flat

    def offsets(self, mat: np.ndarray) -> Dict[str, np.ndarray]:
        """Counter name -> (rows,) int32 invariant-column offsets."""
        hist = self._hist(np.ascontiguousarray(mat))
        return {k: hist @ w for k, w in self.wflat.items()}

    def _hist(self, mat: np.ndarray) -> np.ndarray:
        import ctypes

        from distance_tpu._native import get_lib

        rows, width = mat.shape
        hist = np.zeros((rows, self.nbins), dtype=np.int32)
        lib = get_lib()
        if lib is None:
            keys = self.colkey[None, :].astype(np.int32) + self.idx_lut[mat]
            keys += np.arange(rows, dtype=np.int32)[:, None] * self.nbins
            hist[:] = np.bincount(
                keys.ravel(), minlength=rows * self.nbins
            ).reshape(rows, self.nbins)
            return hist
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_i16 = ctypes.POINTER(ctypes.c_int16)
        p_i32 = ctypes.POINTER(ctypes.c_int32)

        def run(a, b):
            lib.dt_code_hist(
                mat[a:b].ctypes.data_as(p_u8), b - a, width,
                self.colkey.ctypes.data_as(p_i16),
                self.idx_lut.ctypes.data_as(p_u8),
                hist[a:b].ctypes.data_as(p_i32), self.nbins,
            )

        chunk = max(64, rows // 8)
        if rows > 2 * chunk:
            from distance_tpu.finalize import _get_pool

            pool = _get_pool()
            futs = [
                pool.submit(run, a, min(a + chunk, rows))
                for a in range(0, rows, chunk)
            ]
            for f in futs:
                f.result()
        elif rows:
            run(0, rows)
        return hist


def _prune_invariant_columns(mats: Sequence[np.ndarray]):
    """Drop columns where every row (across all given matrices) holds the
    same code — the device-side analog of the reference's
    consensus-difference sparsification (measures.rs:28-53), generalized
    to every measure.

    An invariant column contributes nothing to any difference counter; if
    its common code is an exact base (bit 3) it contributes exactly +1
    per pair to ``same`` (and hence tn93's ``kk``), re-added as a scalar
    offset at finalization.  Exactness is unconditional.

    Returns (pruned_mats, same_offset, pruned_width) or None if pruning
    is not worthwhile.
    """
    first = mats[0][0:1]
    inv = None
    for m in mats:
        eq = (m == first).all(axis=0)
        inv = eq if inv is None else (inv & eq)
    frac = float(inv.mean()) if inv.size else 0.0
    if frac < PRUNE_MIN_FRACTION:
        return None
    keep = ~inv
    same_offset = int((inv & ((first[0] & 8) == 8)).sum())
    pruned = [np.ascontiguousarray(m[:, keep]) for m in mats]
    return pruned, same_offset, int(keep.sum())


def _run_load(setup: Setup) -> None:
    if len(setup.loaded) == 1:
        _sweep_square(setup, setup.loaded[0])
    else:
        _sweep_rectangle(setup, setup.loaded[0], setup.loaded[-1])


def _auto_tile(n: int, backend: str) -> int:
    """Default square pair-tile edge for a sweep over ``n`` target rows.

    Square tiles feed the GEMM better than strip-shaped ones and the
    device rate grows with the tile edge, while the diagonal blocks'
    lower-triangle waste costs ~tile/n of the sweep — so take the largest
    power of two <= n/4 (waste <= ~25%), floored at 2048 (the GEMM rate
    falls off below) and capped at 8192 (device temporaries; _choose_tiles
    re-caps against int32 emission arithmetic for very large n).  The
    floor and cap are defaults until benchmark cells re-derive them.  CPU runs keep small
    tiles so hermetic tests and CPU fallbacks stay fast.
    """
    cap = 8192
    if backend != "numpy":
        import jax

        if jax.default_backend() == "cpu":
            cap = 512
    else:
        cap = 512
    t = 2048 if cap >= 2048 else cap
    while t * 2 <= max(1, n // 4) and t < cap:
        t *= 2
    return min(t, cap)


def _strip_ram_budget(deterministic: bool = False) -> int:
    """Host-RAM allowance for one strip's emission lease (~3 in flight).

    The gather/key/index buffers for a strip cost ~(G+2) x ti x n
    int32s; unbounded ti at very large n would lease tens of GB.  Cap at
    a third of physical RAM (or 48 GB), DISTANCE_TPU_STRIP_RAM overrides.
    ``deterministic`` (sharded / multi-host runs) ignores local RAM —
    every shard host must resolve the SAME strip grid or the merged
    output would interleave wrongly.
    """
    env = int(_os.environ.get("DISTANCE_TPU_STRIP_RAM", 0))
    if env:
        return env
    if deterministic:
        return 48 << 30
    try:
        phys = _os.sysconf("SC_PHYS_PAGES") * _os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        phys = 16 << 30
    return min(48 << 30, phys // 3)


def _cap_tile_ram(ti: int, n2: int, measure: str, deterministic: bool) -> int:
    """Bound the emission lease: ~3 strips of (G+2) int32 buffers."""
    g = len(get_plan(measure).counters)
    budget = _strip_ram_budget(deterministic)
    while ti > 1024 and 3 * (g + 2) * ti * n2 * 4 > budget:
        ti //= 2
    return ti


def _resolve_auto_tiles(setup: Setup) -> None:
    """Pin auto (0) tiles to concrete values BEFORE the resume config is
    recorded: the strip grid defines resume units and multi-host shard
    boundaries, so the resolved numbers — not the auto marker — must go
    into the sidecar (a later resolution under different RAM or devices
    would silently shift the grid and corrupt a resumed or merged
    output).  Uses the same formulas the sweeps use; the sweeps' own
    fallback resolution then sees nonzero values and is a no-op.
    """
    if not setup.loaded:
        return
    n1 = setup.loaded[0].n
    n2 = setup.loaded[-1].n
    width = max(setup.loaded[0].width, 1)
    if setup.streamed is not None:
        pairsites = float(n1) * _stream_group_rows(n1) * width
        n2 = n1
    elif len(setup.loaded) > 1:
        pairsites = float(n1) * n2 * width
    else:
        pairsites = 0.5 * n1 * n1 * width
    backend = _resolve_backend(setup.backend, pairsites)
    deterministic = setup.shard is not None
    if setup.tile_i == 0:
        setup.tile_i = _cap_tile_ram(
            _auto_tile(n1, backend), n2, setup.measure, deterministic
        )
    if setup.tile_j == 0:
        setup.tile_j = _auto_tile(n2, backend)


def _choose_tiles(
    n1: int, n2: int, setup: Setup, backend: str = "numpy"
) -> Tuple[int, int]:
    if setup.tile_i == 0:
        setup.tile_i = _cap_tile_ram(
            _auto_tile(n1, backend), n2, setup.measure,
            setup.shard is not None,
        )
    if setup.tile_j == 0:
        setup.tile_j = _auto_tile(n2, backend)
    ti = min(setup.tile_i, _pow2_at_least(n1))
    # _tri_indices builds int32 position arithmetic over one strip's
    # pairs; cap ti so ti * n2 stays below 2^31 (a wrap would corrupt
    # emission indices silently).  Power-of-two steps keep the tile
    # grid aligned.
    while ti > 8 and ti * max(n2, 1) >= (1 << 31):
        ti //= 2
    tj = min(setup.tile_j, _pow2_at_least(n2))
    if backend == "xla":
        import jax
        import math

        ndev = jax.device_count()
        # Multi-chip pair-DP shards each block's column axis across the
        # mesh; a non-divisible tile would silently fall back to one
        # device, so round the tile up instead (padding keeps slices in
        # bounds; output bytes are tile-size independent).  The multiple
        # is lcm(2*ndev, ti):
        #   * 2*ndev, not ndev, because rel4 nibble lanes halve the
        #     column axis and the halved axis must still divide the
        #     mesh or the cheapest packing rung is lost under GSPMD;
        #   * ti, because every block column start i0 + k*tj must land
        #     on the ti grid — prepare()'s row-padding bound assumes
        #     it, and a misaligned start would let dynamic_slice CLAMP
        #     and silently shift the block's columns (wrong output on
        #     e.g. 6-device topologies).
        mult = math.lcm(2 * ndev, ti)
        if ndev > 1 and tj % mult:
            adj = -(-tj // mult) * mult
            print(
                f"[distance-tpu] note: tile_j {tj} -> {adj}"
                f" (multiple of lcm(2 x {ndev} devices, tile_i {ti}))",
                file=sys.stderr,
            )
            tj = adj
    return ti, tj


def _pow2_at_least(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


# Target size for one device->host transfer request.  The device link can
# have high per-request latency, so strips are fetched in parallel chunks
# of this many bytes rather than block-by-block, and chunk transfers are
# submitted as soon as a strip is dispatched so the link stays busy
# across strips.
FETCH_CHUNK_BYTES = int(_os.environ.get("DISTANCE_TPU_FETCH_CHUNK", 4 << 20))
# Default transfer-pool width follows the machine (the reference defaults
# its worker pool to num_cpus, src/lib.rs:262) with IO oversubscription —
# transfer threads block on the link, they don't burn CPU; -t and the env
# var override.
FETCH_THREADS = int(_os.environ.get("DISTANCE_TPU_FETCH_THREADS", 0)) or min(
    32, 4 * (_os.cpu_count() or 8)
)
# Strips dispatched ahead of the one currently being fetched/emitted.
STRIP_LOOKAHEAD = int(_os.environ.get("DISTANCE_TPU_LOOKAHEAD", 6))

_fetch_pool = None


def _get_fetch_pool(n_threads: Optional[int] = None):
    """Transfer thread pool.  Sized by the first caller: the CLI's -t
    maps here (the reference's worker-thread knob; compute parallelism
    itself belongs to the device)."""
    global _fetch_pool
    if _fetch_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _fetch_pool = ThreadPoolExecutor(n_threads or FETCH_THREADS)
    return _fetch_pool


def configure_fetch_pool(n_threads: int) -> None:
    """Set the transfer pool size before first use (idempotent after).
    An explicit ``-t`` is an exact override (bounded only by a 128
    backstop against absurd values — transfer threads are cheap but
    not free)."""
    if n_threads and n_threads > 0:
        _get_fetch_pool(min(n_threads, 128))


def _chunk_slices(handle, axis: int):
    shape = handle.shape
    if axis >= len(shape):  # low-rank sidecars (e.g. 1-D exceptions)
        return [handle]
    other = int(np.prod(shape)) // max(1, shape[axis])
    bytes_per_slice = other * handle.dtype.itemsize
    chunk = max(1, FETCH_CHUNK_BYTES // max(1, bytes_per_slice))
    if chunk >= shape[axis]:
        return [handle]
    parts = []
    for c0 in range(0, shape[axis], chunk):
        s = [slice(None)] * len(shape)
        s[axis] = slice(c0, c0 + chunk)
        parts.append(handle[tuple(s)])
    return parts


class _AsyncFetch:
    """Device->host transfer of one strip, started eagerly in background
    threads (chunked).  ``result()`` blocks and reassembles.  A tuple
    handle (rel packing) fetches each part and returns a tuple."""

    def __init__(self, handle, axis: int = -1):
        self.axis = axis
        self._parts = None
        if isinstance(handle, tuple):
            self._parts = [_AsyncFetch(h, axis) for h in handle]
            self._arr = None
            self.futures = None
            return
        if isinstance(handle, np.ndarray):
            self._arr = handle
            self.futures = None
            return
        self._arr = None
        pool = _get_fetch_pool()
        self.futures = [
            pool.submit(np.asarray, p) for p in _chunk_slices(handle, axis)
        ]

    def result(self):
        if self._parts is not None:
            return tuple(p.result() for p in self._parts)
        if self._arr is not None:
            return self._arr
        arrs = [f.result() for f in self.futures]
        self._arr = (
            np.concatenate(arrs, axis=self.axis) if len(arrs) > 1 else arrs[0]
        )
        return self._arr


def _chunked_d2h(handle, axis: int) -> np.ndarray:
    """Synchronous chunked device->host copy."""
    if isinstance(handle, np.ndarray):
        return handle
    return _AsyncFetch(handle, axis).result()


# Host->device uploads above this size go in chunks: some transports
# stall on single large transfers.
H2D_CHUNK_BYTES = int(_os.environ.get("DISTANCE_TPU_H2D_CHUNK", 32 << 20))


def _chunked_h2d(arr: np.ndarray):
    """Upload a host matrix to the default device in bounded chunks."""
    import jax
    import jax.numpy as jnp

    if arr.nbytes <= H2D_CHUNK_BYTES:
        return jnp.asarray(arr)
    rows_per = max(1, H2D_CHUNK_BYTES // max(1, arr.shape[1] or 1))
    parts = [
        jax.device_put(arr[r0 : r0 + rows_per])
        for r0 in range(0, arr.shape[0], rows_per)
    ]
    out = jnp.concatenate(parts, axis=0)
    # Force materialization before the part buffers go out of scope.
    out.block_until_ready()
    return out


@functools.lru_cache(maxsize=None)
def _bundle_jits():
    """Jitted sidecar fusers (one per arity); jax retraces per shape."""
    import jax
    import jax.numpy as jnp

    from distance_tpu.ops.packing import bundle_sidecars

    @jax.jit
    def f3(cb, rb_cc):
        return bundle_sidecars(jnp, cb, rb_cc)

    @jax.jit
    def f5(cb, rb_cc, exc_idx, exc_val):
        return bundle_sidecars(jnp, cb, rb_cc, exc_idx, exc_val)

    return f3, f5


def _dispatch_strip(eng: _BlockEngine, m1, m2, i0: int, col_starts, ti, tj,
                    mode: Optional[str] = None, nv=None, diag_off=None):
    """Dispatch all column blocks of one strip; device-concat the packed
    outputs into a single (P, ti, span) handle (one logical transfer).
    rel-packed blocks yield (lanes, cb, rb_cc[, exceptions]) tuples:
    lanes/cb concat along the column axis, rb_cc is strip-constant
    (first copy kept), per-block (CAP,) exception sidecars stack to
    (B, CAP) with block-local indices (host translates by tj).  All the
    small arrays then fuse into ONE sidecar bundle so the strip costs
    two D2H requests total (lanes + bundle)."""
    gyf = eng.gfeat_of(m2)
    if gyf is not None and not eng.gcache_usable(col_starts):
        gyf = None  # sharded blocked cache needs tj-aligned starts
    if gyf is not None:
        # Cached-feature path: the strip's f-features build once, the
        # matrix's g-features were built once at prepare() — blocks are
        # pure slice+GEMM(+pack).  Counters are byte-identical to the
        # recomputing path (same integer contraction over the same
        # operands).
        if mode is None:
            mode = eng.pack_mode
        if diag_off is None and m1 is m2:
            diag_off = 0
        if mode in ("rel", "rel4") and eng.rel_ref_f is None:
            gyf = None  # no ref features staged; fall through
        else:
            fx = eng.fx_strip(m1, i0, ti)
            handles = [
                eng.block_feat(fx, gyf, i0, j0, ti, tj, mode, nv, diag_off)
                for j0 in col_starts
            ]
    if gyf is None:
        handles = [
            eng.block(m1, m2, i0, j0, ti, tj, mode, nv, diag_off)
            for j0 in col_starts
        ]
    if eng.backend == "numpy":
        return np.concatenate(handles, axis=-1)
    import jax.numpy as jnp

    if isinstance(handles[0], tuple):
        if len(handles) == 1:
            parts = handles[0]
        else:
            parts = (
                jnp.concatenate([h[0] for h in handles], axis=-1),
                jnp.concatenate([h[1] for h in handles], axis=-1),
                handles[0][2],
            )
            if len(handles[0]) == 5:
                parts += (
                    jnp.stack([h[3] for h in handles]),
                    jnp.stack([h[4] for h in handles]),
                )
        f3, f5 = _bundle_jits()
        bundle = f5(*parts[1:]) if len(parts) == 5 else f3(*parts[1:])
        return parts[0], bundle
    return jnp.concatenate(handles, axis=-1) if len(handles) > 1 else handles[0]


def _fetch_strip(
    eng: _BlockEngine,
    handle,
    valid_rows: Optional[int] = None,
    valid_cols: Optional[int] = None,
    redispatch=None,
) -> np.ndarray:
    """Strip transfer + unpack -> (G, rows, cols) int32 counters.

    ``handle`` is an _AsyncFetch (eagerly started transfer) or a device
    array.  With narrow packing, saturated lanes (a counter >= 255 within
    the valid region) trigger one wide redispatch via ``redispatch()``.
    ``valid_rows``/``valid_cols`` bound the region that will be emitted —
    padding rows/columns saturate by construction and are ignored.
    """
    arr = handle.result() if isinstance(handle, _AsyncFetch) else (
        handle if isinstance(handle, (np.ndarray, tuple))
        else _chunked_d2h(handle, axis=-1)
    )
    if eng.backend == "numpy":
        return arr
    if isinstance(arr, tuple):
        # rel pack (lanes, bundle) or (lanes, cb, rb_cc[, exceptions]);
        # maybe device arrays
        arr = tuple(
            a if isinstance(a, np.ndarray) else np.asarray(a) for a in arr
        )
        if valid_cols is None:
            # rel call sites always pass explicit crop bounds; the
            # bundled 2-tuple cannot derive a column default locally
            assert len(arr) > 2, "rel fetch requires valid_cols"
            valid_cols = arr[1].shape[1]
        vr = arr[0].shape[1] if valid_rows is None else valid_rows
        vc = valid_cols
    else:
        vr = arr.shape[1] if valid_rows is None else valid_rows
        vc = arr.shape[2] if valid_cols is None else valid_cols
    return _finish_fetched(eng, arr, vr, vc, redispatch, axis=-1)


def _finish_fetched(eng: _BlockEngine, arr, vr: int, vc: int, redispatch,
                    axis: int) -> np.ndarray:
    """Shared unpack + saturation-refetch ladder for a fetched strip
    (axis=-1) or stream batch (axis=1): rel-family tuples reconstruct
    via _unpack_rel_parts with the rel->wide escalation; packed arrays
    crop then unpack (the handle's dtype identifies how it was packed
    at dispatch time — int8 = narrow — since the engine's current mode
    may have moved on), with a wide refetch on 8-bit saturation."""
    if isinstance(arr, tuple):
        counters, was4 = _unpack_rel_parts(eng, arr, vr, vc)
        (eng.note_rel4 if was4 else eng.note_rel)(counters is None)
        if counters is not None:
            return counters
        return _rel_wide_refetch(eng, redispatch, vr, vc, axis,
                                 try_rel=was4)
    arr = arr[:, :vr, :vc]
    if eng.packed and arr.dtype == np.int8:
        from distance_tpu.ops.packing import unpack_host_narrow

        counters = unpack_host_narrow(eng.measure, arr, eng.width)
        eng.note_narrow(counters is None)
        if counters is not None:
            return counters
        # A counter saturated 8 bits — refetch wide.
        wide = redispatch("wide")
        arr = _chunked_d2h(wide, axis=axis)[:, :vr, :vc]
        from distance_tpu.ops.packing import unpack_host

        return unpack_host(eng.measure, arr)
    if eng.packed:
        from distance_tpu.ops.packing import unpack_host

        return unpack_host(eng.measure, arr)
    return arr


def _pipeline_strips(strip_iter, emit_fn):
    """Run dispatch ahead of fetch+emit (the bounded-channel analog)."""
    pending: List[tuple] = []
    for item in strip_iter:
        pending.append(item)
        while len(pending) > STRIP_LOOKAHEAD:
            emit_fn(pending.pop(0))
    while pending:
        emit_fn(pending.pop(0))


class _AsyncEmitter:
    """Ordered single-thread executor for the format+write tail.

    The reference dedicates a thread to its ordered writer
    (lib.rs:377-385); here the expensive emission tail (row formatting,
    file write, progress checkpoint) runs on one background thread in
    submission order, overlapping the next strip's fetch/unpack/finalize
    on the main thread.  Exceptions re-raise on the submitting side.
    """

    def __init__(self, depth: int = 2):
        import queue as _queue
        import threading

        self._q: "_queue.Queue" = _queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                self._done.set()
                return
            if self._err is None:
                try:
                    fn()
                except BaseException as e:
                    self._err = e

    def submit(self, fn) -> None:
        # A failed tail poisons the emitter permanently: every later
        # submit and finish() re-raise, and the worker runs nothing
        # more — work submitted after the first raise must not silently
        # execute (round-2 review finding).
        if self._err is not None:
            raise self._err
        self._q.put(fn)

    def finish(self) -> None:
        self._q.put(None)
        self._done.wait()
        self._thread.join()
        if self._err is not None:
            raise self._err


# Device-memory budget for resident sequence data (codes plus the
# g-feature cache); beyond it the blocked out-of-core sweep stages
# super-rows through device memory.  None derives it from the device
# (_hbm_budget).
HBM_BUDGET_BYTES: Optional[int] = _env_bytes("DISTANCE_TPU_HBM_BUDGET")


def _split_strips(weights: List[int], shard: Optional[Tuple[int, int]]):
    """Balanced contiguous split of strips by pair-count weight.

    Returns the [a, b) strip-index range for this shard (the whole range
    when unsharded).  Boundaries are where the cumulative weight crosses
    total*j/N, so every shard gets ~equal pairs even though square-mode
    strips shrink toward the bottom of the triangle.
    """
    if shard is None:
        return 0, len(weights)
    k, nshards = shard
    total = sum(weights) or 1
    cum = 0
    bounds = [0]
    target_idx = 1
    for idx, w in enumerate(weights):
        cum += w
        while target_idx < nshards and cum >= total * target_idx / nshards:
            bounds.append(idx + 1)
            target_idx += 1
    while len(bounds) < nshards:
        bounds.append(len(weights))
    bounds.append(len(weights))
    return bounds[k], bounds[k + 1]


def _prepared_footprint(n: int, width: int, ti: int, max_block: int,
                        measure: str, backend: str,
                        cache_g: bool = True,
                        tj: Optional[int] = None) -> int:
    """Device bytes an in-core ``prepare(matrix, max_block)`` on a
    strip-stride-``ti`` engine will hold resident: padded codes plus
    the g-side feature cache IF the engagement predicates in
    :meth:`_BlockEngine.prepare` will fire.  Replays prepare's exact
    n_pad formula (strips of ``ti`` rows, last padded to ``max_block``)
    — the in-core/out-of-core gates compare THIS against the HBM
    budget; raw source bytes under-count by up to
    (1 + total_channels)x when the cache engages.  ``tj``: the engine's
    column tile — on a sharded engine the blocked g-cache builder pads
    cache rows up to a tj multiple, and the footprint must replay that
    rounding too."""
    if backend == "numpy":
        return 0
    n_strips = max(1, -(-n // ti))
    n_pad = max((n_strips - 1) * ti + max(max_block, ti), max_block)
    l_pad = -(-max(width, 1) // 128) * 128
    mat = n_pad * l_pad
    if cache_g and backend == "xla" and _featcache_budget() > 0:
        rows = n_pad
        if tj is not None and _device_mesh(tj) is not None:
            rows = -(-n_pad // tj) * tj
        need = get_plan(measure).total_channels * rows * l_pad
        if need <= _featcache_budget() and need + mat <= _hbm_budget():
            mat += need
    return mat


def _sweep_square(setup: Setup, aln: Alignment) -> None:
    n, width = aln.n, aln.width
    if setup.shard is None or setup.shard[0] == 0:
        setup.writer.header()
    if n < 2:
        return
    source = aln.matrix
    same_offset = 0
    pruned = _prune_invariant_columns([aln.matrix])
    if pruned is not None:
        (source,), same_offset, width = pruned
    backend = _resolve_backend(setup.backend, 0.5 * n * n * max(width, 1))
    ti, tj = _choose_tiles(n, n, setup, backend)
    footprint = _prepared_footprint(
        n, width, ti, max(ti, tj), setup.measure, backend, tj=tj
    )
    if backend != "numpy" and footprint > _hbm_budget():
        print(
            f"[distance-tpu] out-of-core sweep: {footprint / 1e9:.2f} GB"
            f" prepared matrix > {_hbm_budget() / 1e9:.2f} GB HBM"
            " budget",
            file=sys.stderr,
        )
        _sweep_square_blocked(setup, aln, source, width, same_offset, backend)
        return
    eng = _BlockEngine(setup.measure, backend, ti, tj, width)
    with phase_timer("prepare-upload"):
        mat = eng.prepare(
            source, max(ti, tj), diff_ref=eng.diff_ref_for(source)
        )
    plan = eng.plan

    strip_starts = list(range(0, n - 1, ti))
    weights = [
        sum(n - 1 - i for i in range(i0, min(i0 + ti, n)))
        for i0 in strip_starts
    ]
    a, b = _split_strips(weights, setup.shard)
    done = _resume_skip(setup)
    from distance_tpu.utils.timing import ProgressMeter

    meter = ProgressMeter("sweep", weights[a + done : b])
    emitter = _AsyncEmitter()
    pool = _ScratchPool()

    def strips():
        for ordinal, i0 in enumerate(strip_starts[a:b]):
            if ordinal < done:
                continue
            col_starts = list(range(i0, n, tj))
            yield ordinal, i0, col_starts, _AsyncFetch(
                _dispatch_strip(eng, mat, mat, i0, col_starts, ti, tj,
                                nv=(n, n))
            )

    def emit(item):
        ordinal, i0, col_starts, handle = item
        si = min(ti, n - i0)
        strip = _fetch_strip(
            eng, handle, si, n - i0,
            redispatch=lambda mode: _dispatch_strip(
                eng, mat, mat, i0, col_starts, ti, tj, mode, nv=(n, n)
            ),
        )
        # Rows i0..i0+si-1 in order: (i, j) for j in i+1..n.
        lease: List[np.ndarray] = []
        with phase_timer("gather"):
            gathered = _gather_emit(strip, si, i0, n, i0, pool, lease)
        if gathered is None:
            return
        rows_c, pair_i, col_idx = gathered
        counters = {
            name: rows_c[k] for k, name in enumerate(plan.counters)
        }
        _emit_pairs(
            setup, aln, aln, pair_i, col_idx, counters, same_offset,
            emitter=emitter,
            after=lambda ordinal=ordinal: (
                _progress_mark(setup, ordinal + 1), meter.tick()
            ),
            pool=pool, lease=lease,
        )

    _pipeline_strips(strips(), emit)
    emitter.finish()


# Host RAM allowed for one emission group's counter buffer (out-of-core).
HOST_BUF_BUDGET = int(
    _os.environ.get("DISTANCE_TPU_HOST_BUF_BUDGET", 4 << 30)
)

# Minimum rows per staged stream group: below this the per-group
# dispatch/upload overhead dominates.  Module-level so tests can lower
# it and make the HOST_BUF_BUDGET cap the binding constraint.
STAGED_ROWS_FLOOR = 256


class _StagedSide:
    """Cross-group reuse of one host-resident matrix staged through HBM
    in super-rows (out-of-core sweeps, staged stream loaded side).

    The round-4 at-scale rectangle row spent 109.7 s of 128 s re-encoding
    and re-uploading every file2 super-row once per X group with no
    cross-group reuse.  Two levels fix that:

    - host: each super-row's diff encoding memoizes across stagings
      (prepare(h2d_memo=) skips the pad/compare/extract host passes and
      ships only the cached (idx, vals) diffs on re-upload);
    - device: the most recently staged super-row is NOT released at
      group end.  Combined with the callers' serpentine sweep order
      (ascending/descending on alternate X groups), the next group's
      first super-row is a device hit — no upload, no feature rebuild —
      within the same HBM footprint (one X slot + one Y slot).
    """

    def __init__(self, eng: "_BlockEngine", source: np.ndarray,
                 row_tile: int, diff_ref, cache_g: bool = True) -> None:
        self.eng = eng
        self.source = source
        self.row_tile = row_tile
        self.diff_ref = diff_ref
        self.cache_g = cache_g
        self._memos: Dict[tuple, dict] = {}
        self._memo_bytes = 0
        self._dev = None
        self._key = None
        self._serp = False

    def serpentine(self, spans: list) -> list:
        """Alternate iteration direction on successive sweeps so the
        last staged super-row of one sweep is the first of the next —
        a device cache hit at every group boundary."""
        self._serp = not self._serp
        return list(spans) if self._serp else list(reversed(spans))

    def get(self, q0: int, q1: int):
        """The prepared device matrix for source[q0:q1] (device-cached
        when it was the previous staging; host-encode-memoized always)."""
        key = (q0, q1)
        if self._key == key:
            return self._dev
        self.drop()
        # host-RAM guard: stop admitting NEW encode memos past HALF the
        # host-buffer budget — the sweeps' group/counter buffers size
        # themselves to the OTHER half (their group caps use
        # HOST_BUF_BUDGET // 2), so buffers + memos together honor the
        # documented knob (overflow spans just re-encode, the round-4
        # behavior)
        memo = self._memos.get(key)
        if memo is None and self._memo_bytes < HOST_BUF_BUDGET // 2:
            memo = self._memos[key] = {}
        prev = memo.get("enc") if memo is not None else None
        # prepare() reuses the engine's uploader when diff_ref is the
        # same object (including a stream-retargeted one, whose memos
        # revalidate per uploader), so passing it every time is free
        self._dev = self.eng.prepare(
            self.source[q0:q1], self.row_tile, row_tile=self.row_tile,
            diff_ref=self.diff_ref, cache_g=self.cache_g,
            h2d_memo=memo,
        )
        if memo is not None:
            # identity-based accounting: prepare may REPLACE a memoized
            # encoding (uploader swapped by a stream retarget, or n_pad
            # changed), not just fill an empty slot
            enc = memo.get("enc")
            if enc is not prev:
                if prev is not None:
                    self._memo_bytes -= prev[0].nbytes + prev[1].nbytes
                if enc is not None:
                    self._memo_bytes += enc[0].nbytes + enc[1].nbytes
        self._key = key
        return self._dev

    def drop(self) -> None:
        """Release the device-resident super-row (not the host memos)."""
        if self._dev is not None:
            self.eng.release(self._dev)
            self._dev, self._key = None, None


def _sweep_square_blocked(setup: Setup, aln: Alignment, source: np.ndarray,
                          width: int, same_offset: int, backend: str) -> None:
    """Out-of-core square sweep for alignments larger than HBM.

    The matrix stays host-resident; X row-groups and Y super-rows are
    staged through HBM (classic blocked GEMM).  For each emission group
    of X rows, every Y super-row is swept and the group's counters
    accumulate in a host buffer; the group's rows then emit in canonical
    order, so output bytes are identical to the in-core sweep.
    """
    n = aln.n
    ti, tj = _choose_tiles(n, n, setup, backend)
    eng = _BlockEngine(setup.measure, backend, ti, tj, width)
    plan = eng.plan
    l_pad = -(-max(width, 1) // 128) * 128

    # Y super-rows sized to ~1/3 of the HBM budget; X groups bounded by
    # both the device budget and the host counter-buffer budget.  With
    # the g-side feature cache on, a staged Y row costs (1 + R) x l_pad
    # bytes (codes + int8 features) — smaller super-rows, but every strip
    # of the group reuses the super-row's features instead of rebuilding
    # them (H2D bytes per group are unchanged: codes upload only).
    row_bytes = l_pad * (
        1 + eng.plan.total_channels if eng.feat_cache_on else 1
    )
    sr_rows = max(tj, (_hbm_budget() // 3 // row_bytes) // tj * tj)
    bytes_per_pair = 4 * len(plan.counters)
    # half the host budget: the other half is _StagedSide's encode-memo
    # admission cap — together they honor HOST_BUF_BUDGET
    group_cap = max(ti,
                    int(HOST_BUF_BUDGET // 2 // max(1, n * bytes_per_pair))
                    // ti * ti)
    # The X group gets its own ti-aligned HBM cap: group_rows MUST be a
    # multiple of ti or the resume/progress ordinals (abs_i0 - row_lo)
    # // ti collide across groups and --resume silently skips
    # never-emitted strips (sr_rows is only tj-aligned; ti != tj
    # happens at auto tiles whenever n1 >> n2, and via Setup.tile_i/j)
    x_cap = max(ti, (_hbm_budget() // 3 // row_bytes) // ti * ti)
    group_rows = min(x_cap, group_cap)

    # Multi-host sharding: restrict to this shard's strip row range.
    strip_starts = list(range(0, n - 1, ti))
    weights = [
        sum(n - 1 - i for i in range(i0, min(i0 + ti, n)))
        for i0 in strip_starts
    ]
    a, b = _split_strips(weights, setup.shard)
    if a >= b:
        return
    done = _resume_skip(setup)
    row_lo = strip_starts[a]
    row_hi = min(n, strip_starts[b - 1] + ti)
    from distance_tpu.utils.timing import ProgressMeter

    meter = ProgressMeter("sweep (out-of-core)", weights[a + done : b])
    emitter = _AsyncEmitter()
    pool = _ScratchPool()
    dref = eng.diff_ref_for(source)
    yside = _StagedSide(eng, source, tj, dref)

    for g0 in range(row_lo, row_hi, group_rows):
        g1 = min(g0 + group_rows, row_hi, n)
        # resume: skip groups whose strips are all already emitted
        last_ordinal = (g1 - 1 - row_lo) // ti
        if last_ordinal < done:
            continue
        with phase_timer("ooc-xgroup-prepare"):
            dev_x = eng.prepare(source[g0:g1], ti, row_tile=ti,
                                diff_ref=dref, cache_g=False, cache_f=True)
        span = n - g0
        bufs = np.zeros((len(plan.counters), g1 - g0, span), dtype=np.int32)

        q_start = (g0 // sr_rows) * sr_rows
        spans = [
            (q0, min(q0 + sr_rows, n))
            for q0 in range(q_start, n, sr_rows)
            if min(q0 + sr_rows, n) > g0
        ]
        # serpentine: accumulation order into bufs is output-invariant,
        # and the boundary super-row stays device-resident across groups
        for q0, q1 in yside.serpentine(spans):
            with phase_timer("ooc-stage"):
                # drop the previous super-row's reference BEFORE the
                # next staging uploads, or two Y slots are transiently
                # device-resident (all of this group's fetches have
                # completed, so nothing can still redispatch against it)
                dev_y = None
                dev_y = yside.get(q0, q1)
            sr_items = []
            for i0_loc in range(0, g1 - g0, ti):
                abs_i0 = g0 + i0_loc
                # only columns j > abs_i0 are emitted; start at the
                # aligned block containing abs_i0 (or 0 if the SR is
                # entirely to the right)
                if q1 <= abs_i0 + 1:
                    continue
                lo_loc = max(0, ((abs_i0 - q0) // tj) * tj) if q0 <= abs_i0 else 0
                col_starts = list(range(lo_loc, q1 - q0, tj))
                handle = _AsyncFetch(_dispatch_strip(
                    eng, dev_x, dev_y, i0_loc, col_starts, ti, tj,
                    nv=(g1 - g0, q1 - q0), diag_off=g0 - q0
                ))
                sr_items.append((i0_loc, col_starts, handle))
            for i0_loc, col_starts, handle in sr_items:
                si = min(ti, g1 - g0 - i0_loc)
                vcols = (q1 - q0) - col_starts[0]
                with phase_timer("ooc-fetch-wait"):
                    strip = _fetch_strip(
                        eng, handle, si, vcols,
                        redispatch=lambda mode, i0_loc=i0_loc,
                        col_starts=col_starts, g0=g0, g1=g1, q0=q0, q1=q1:
                        _dispatch_strip(
                            eng, dev_x, dev_y, i0_loc, col_starts, ti, tj,
                            mode, nv=(g1 - g0, q1 - q0), diag_off=g0 - q0
                        ),
                    )
                c0_abs = q0 + col_starts[0]
                # the first tj-aligned block can begin before the
                # group's column origin g0 (when ti is not a multiple of
                # tj); clip those columns instead of letting a negative
                # offset wrap the buffer
                dst0 = c0_abs - g0
                if dst0 < 0:
                    strip = strip[:, :, -dst0:]
                    dst0 = 0
                bufs[
                    :, i0_loc : i0_loc + si,
                    dst0 : dst0 + strip.shape[2],
                ] = strip

        # Emit the group's rows in canonical order.
        for i0_loc in range(0, g1 - g0, ti):
            abs_i0 = g0 + i0_loc
            ordinal = (abs_i0 - row_lo) // ti
            if ordinal < done:
                continue
            si = min(ti, g1 - g0 - i0_loc)
            lease: List[np.ndarray] = []
            gathered = _gather_emit(
                bufs[:, i0_loc : i0_loc + si], si, abs_i0, n, g0,
                pool, lease,
            )
            if gathered is None:
                continue
            rows_c, pair_i, col_idx = gathered
            counters = {
                name: rows_c[k] for k, name in enumerate(plan.counters)
            }
            _emit_pairs(
                setup, aln, aln, pair_i, col_idx, counters, same_offset,
                emitter=emitter,
                after=lambda ordinal=ordinal: (
                    _progress_mark(setup, ordinal + 1), meter.tick()
                ),
                pool=pool, lease=lease,
            )
        eng.release(dev_x)
        dev_x = None
    yside.drop()
    emitter.finish()


def _sweep_rectangle(setup: Setup, aln1: Alignment, aln2: Alignment) -> None:
    n1, n2 = aln1.n, aln2.n
    width = aln1.width
    if setup.shard is None or setup.shard[0] == 0:
        setup.writer.header()
    src1, src2 = aln1.matrix, aln2.matrix
    same_offset = 0
    pruned = _prune_invariant_columns([aln1.matrix, aln2.matrix])
    if pruned is not None:
        (src1, src2), same_offset, width = pruned
    backend = _resolve_backend(setup.backend, float(n1) * n2 * max(width, 1))
    ti, tj = _choose_tiles(n1, n2, setup, backend)
    # file1 strips are prepared with cache_g=False (the f side), file2
    # with the g-feature cache when it engages — account for both.
    # Both prepares pad rows with the ENGINE's strip stride ti (file2's
    # max_block is tj): modeling file2 with a tj stride under-counts by
    # up to max(ti, tj) rows x (1 + channels) x l_pad at ti != tj.
    footprint = (
        _prepared_footprint(n1, width, ti, ti, setup.measure, backend,
                            cache_g=False)
        + _prepared_footprint(n2, width, ti, tj, setup.measure, backend,
                              tj=tj)
    )
    if backend != "numpy" and footprint > _hbm_budget():
        print(
            f"[distance-tpu] out-of-core rectangle sweep:"
            f" {footprint / 1e9:.2f} GB prepared matrices >"
            f" {_hbm_budget() / 1e9:.2f} GB HBM budget",
            file=sys.stderr,
        )
        _sweep_rectangle_blocked(
            setup, aln1, aln2, src1, src2, width, same_offset, backend
        )
        return
    eng = _BlockEngine(setup.measure, backend, ti, tj, width)
    dref = eng.diff_ref_for(src1)
    with phase_timer("prepare-upload"):
        m1 = eng.prepare(src1, ti, diff_ref=dref, cache_g=False)
        m2 = eng.prepare(src2, tj, diff_ref=dref)
    plan = eng.plan
    col_starts = list(range(0, n2, tj))

    strip_starts = list(range(0, n1, ti))
    weights = [min(ti, n1 - i0) * n2 for i0 in strip_starts]
    a, b = _split_strips(weights, setup.shard)
    done = _resume_skip(setup)
    emitter = _AsyncEmitter()
    pool = _ScratchPool()

    def strips():
        for ordinal, i0 in enumerate(strip_starts[a:b]):
            if ordinal < done:
                continue
            yield ordinal, i0, _AsyncFetch(
                _dispatch_strip(eng, m1, m2, i0, col_starts, ti, tj,
                                nv=(n1, n2))
            )

    def emit(item):
        ordinal, i0, handle = item
        si = min(ti, n1 - i0)
        strip = _fetch_strip(
            eng, handle, si, n2,
            redispatch=lambda mode: _dispatch_strip(
                eng, m1, m2, i0, col_starts, ti, tj, mode, nv=(n1, n2)
            ),
        )
        # row-major over the full (si, n2) rectangle
        lease: List[np.ndarray] = []
        gathered = _gather_emit(strip, si, i0, n2, 0, pool, lease,
                                tri=False)
        if gathered is None:
            return
        rows_c, pair_i, col_idx = gathered
        counters = {
            name: rows_c[k] for k, name in enumerate(plan.counters)
        }
        _emit_pairs(
            setup, aln1, aln2, pair_i, col_idx, counters, same_offset,
            emitter=emitter,
            after=lambda ordinal=ordinal: _progress_mark(
                setup, ordinal + 1
            ),
            pool=pool, lease=lease,
        )

    _pipeline_strips(strips(), emit)
    emitter.finish()


def _sweep_rectangle_blocked(setup: Setup, aln1: Alignment, aln2: Alignment,
                             src1: np.ndarray, src2: np.ndarray, width: int,
                             same_offset: int, backend: str) -> None:
    """Out-of-core two-file sweep for matrices larger than HBM.

    The reference computes file1 x file2 for any alignments that fit
    host RAM (lib.rs:551-596, fastaio.rs:202-212) — its memory bound is
    the host, not the accelerator.  This is the device analog of
    _sweep_square_blocked for the rectangle: both matrices stay
    host-resident, X row-groups (file1) and Y super-rows (file2) stage
    through HBM, and each X group's counters accumulate in a host buffer
    before its rows emit in canonical row-major order — output bytes
    identical to the in-core rectangle sweep.
    """
    n1, n2 = aln1.n, aln2.n
    ti, tj = _choose_tiles(n1, n2, setup, backend)
    eng = _BlockEngine(setup.measure, backend, ti, tj, width)
    plan = eng.plan
    l_pad = -(-max(width, 1) // 128) * 128
    row_bytes = l_pad * (
        1 + eng.plan.total_channels if eng.feat_cache_on else 1
    )
    sr_rows = max(tj, (_hbm_budget() // 3 // row_bytes) // tj * tj)
    bytes_per_pair = 4 * len(plan.counters)
    # half the host budget; the other half is _StagedSide's memo cap
    group_cap = max(ti,
                    int(HOST_BUF_BUDGET // 2 // max(1, n2 * bytes_per_pair))
                    // ti * ti)
    # ti-aligned X cap: see _sweep_square_blocked — a tj-aligned
    # group_rows collides resume ordinals when ti != tj
    x_cap = max(ti, (_hbm_budget() // 3 // row_bytes) // ti * ti)
    group_rows = min(x_cap, group_cap)

    strip_starts = list(range(0, n1, ti))
    weights = [min(ti, n1 - i0) * n2 for i0 in strip_starts]
    a, b = _split_strips(weights, setup.shard)
    if a >= b:
        return
    done = _resume_skip(setup)
    row_lo = strip_starts[a]
    row_hi = min(n1, strip_starts[b - 1] + ti)
    from distance_tpu.utils.timing import ProgressMeter

    meter = ProgressMeter("sweep (out-of-core rect)", weights[a + done : b])
    emitter = _AsyncEmitter()
    pool = _ScratchPool()
    dref = eng.diff_ref_for(src1)
    yside = _StagedSide(eng, src2, tj, dref)
    all_spans = [
        (q0, min(q0 + sr_rows, n2)) for q0 in range(0, n2, sr_rows)
    ]

    for g0 in range(row_lo, row_hi, group_rows):
        g1 = min(g0 + group_rows, row_hi)
        last_ordinal = (g1 - 1 - row_lo) // ti
        if last_ordinal < done:
            continue
        with phase_timer("ooc-xgroup-prepare"):
            dev_x = eng.prepare(src1[g0:g1], ti, row_tile=ti,
                                diff_ref=dref, cache_g=False, cache_f=True)
        bufs = np.zeros((len(plan.counters), g1 - g0, n2), dtype=np.int32)

        for q0, q1 in yside.serpentine(all_spans):
            with phase_timer("ooc-stage"):
                # see _sweep_square_blocked: release before re-staging
                dev_y = None
                dev_y = yside.get(q0, q1)
            col_starts = list(range(0, q1 - q0, tj))
            sr_items = []
            for i0_loc in range(0, g1 - g0, ti):
                handle = _AsyncFetch(_dispatch_strip(
                    eng, dev_x, dev_y, i0_loc, col_starts, ti, tj,
                    nv=(g1 - g0, q1 - q0)
                ))
                sr_items.append((i0_loc, handle))
            for i0_loc, handle in sr_items:
                si = min(ti, g1 - g0 - i0_loc)
                with phase_timer("ooc-fetch-wait"):
                    strip = _fetch_strip(
                        eng, handle, si, q1 - q0,
                        redispatch=lambda mode, i0_loc=i0_loc, g0=g0,
                        g1=g1, q0=q0, q1=q1, col_starts=col_starts:
                        _dispatch_strip(
                            eng, dev_x, dev_y, i0_loc, col_starts, ti,
                            tj, mode, nv=(g1 - g0, q1 - q0)
                        ),
                    )
                bufs[
                    :, i0_loc : i0_loc + si, q0 : q0 + strip.shape[2]
                ] = strip

        # Emit the group's rows in canonical row-major order.
        for i0_loc in range(0, g1 - g0, ti):
            abs_i0 = g0 + i0_loc
            ordinal = (abs_i0 - row_lo) // ti
            if ordinal < done:
                continue
            si = min(ti, g1 - g0 - i0_loc)
            lease: List[np.ndarray] = []
            gathered = _gather_emit(
                bufs[:, i0_loc : i0_loc + si], si, abs_i0, n2, 0,
                pool, lease, tri=False,
            )
            if gathered is None:
                continue
            rows_c, pair_i, col_idx = gathered
            counters = {
                name: rows_c[k] for k, name in enumerate(plan.counters)
            }
            _emit_pairs(
                setup, aln1, aln2, pair_i, col_idx, counters, same_offset,
                emitter=emitter,
                after=lambda ordinal=ordinal: (
                    _progress_mark(setup, ordinal + 1), meter.tick()
                ),
                pool=pool, lease=lease,
            )
        eng.release(dev_x)
        dev_x = None
    yside.drop()
    emitter.finish()


# ---------------------------------------------------------------------------
# Streamed sweep
# ---------------------------------------------------------------------------

def _run_stream(setup: Setup) -> None:
    aln = setup.loaded[0]
    n1, width = aln.n, aln.width
    # Multi-host stream sharding: device-dispatch groups are assigned
    # round-robin by global group ordinal (every shard parses the whole
    # stream — cheap next to the n1 x rows compute — but dispatches only
    # its groups).  Emission order within a shard is ascending ordinal,
    # so a .units byte index per part lets the multi-host merge
    # interleave parts into the exact single-host byte stream.
    shard_k, shard_n = setup.shard if setup.shard is not None else (0, 1)
    done = _resume_skip(setup)
    unit_index = None
    if setup.shard is not None and setup.out_path is not None:
        from distance_tpu.parallel.multihost import UnitIndex

        unit_index = UnitIndex(setup.out_path)
        if done:
            if not unit_index.load() or len(unit_index.units) < done:
                raise DistanceError(
                    "Cannot resume sharded stream: missing or short"
                    f" units index {unit_index.sidecar}"
                )
            unit_index.truncate(done)
    setup.writer.header()
    if unit_index is not None and not done:
        try:
            unit_index.preamble = setup.writer.tell()
        except (OSError, AttributeError):
            unit_index = None
    # Records stream at the user's -b granularity (reference semantics,
    # fastaio.rs:256-277); the engine groups consecutive user batches
    # into device dispatch groups (_stream_group_rows).  Success output is
    # independent of -b; on a mid-stream error, every fully-read user
    # batch is emitted — matching the reference's pipeline, where the
    # writer has consumed all batches sent before the reader failed.
    user_b = max(1, setup.batchsize)
    split = None
    if not _os.environ.get("DISTANCE_TPU_NO_STREAM_SPLIT"):
        cand = _StreamSplit(aln.matrix, get_plan(setup.measure))
        if cand.frac >= PRUNE_MIN_FRACTION:
            split = cand
    width_dev = int(split.keep.sum()) if split is not None else width
    grows = _stream_group_rows(n1)
    backend = _resolve_backend(
        setup.backend, float(n1) * grows * max(width_dev, 1)
    )
    # Staged stream: loaded side larger than the HBM budget stays
    # host-resident and is swept in super-rows per dispatch group
    # (reference memory model: loaded alignment + one batch in host RAM,
    # lib.rs:269-365).  Bigger groups amortize the per-group re-upload.
    l_pad_s = -(-max(width_dev, 1) // 128) * 128
    staged = (
        backend != "numpy" and float(n1) * l_pad_s > _hbm_budget()
    )
    pending_cap = STREAM_PENDING
    if staged:
        if not _os.environ.get("DISTANCE_TPU_STREAM_GROUP"):
            grows = max(grows, 2048)
            # each staged group assembles a (C, n1, grows) int32 host
            # buffer; bound it by HALF of HOST_BUF_BUDGET (the other
            # half is _StagedSide's encode-memo cap) or a large loaded
            # side (the very case that triggers staging) silently holds
            # tens of GB of host RAM across the in-flight groups
            bytes_per_col = 4 * len(get_plan(setup.measure).counters) * n1
            cap_rows = max(
                STAGED_ROWS_FLOOR,
                HOST_BUF_BUDGET // 2 // max(1, bytes_per_col) // 2 * 2,
            )
            grows = min(grows, cap_rows)
        grp_bytes = 4 * len(get_plan(setup.measure).counters) * n1 * grows
        pending_cap = max(
            1, min(STREAM_PENDING, HOST_BUF_BUDGET // 2 // max(1, grp_bytes))
        )
    ti = min(setup.tile_i or _auto_tile(n1, backend), _pow2_at_least(n1))
    eng = _BlockEngine(setup.measure, backend, ti, grows, width_dev)
    mat_dev_loaded = (
        np.ascontiguousarray(aln.matrix[:, split.keep])
        if split is not None else aln.matrix
    )
    # Diff-encoded uploads: streamed records share ancestry with the
    # loaded alignment, so its per-column mode is a good reference row
    # (each batch falls back to dense when too diverse — diffup.py)
    diff_ref = None
    if backend != "numpy" and not _os.environ.get(
        "DISTANCE_TPU_NO_DIFF_UPLOAD"
    ):
        from distance_tpu.ops.diffup import mode_row

        diff_ref = mode_row(mat_dev_loaded)
    if staged:
        print(
            f"[distance-tpu] staged stream: {n1 * l_pad_s / 1e9:.2f} GB"
            f" loaded matrix > {_hbm_budget() / 1e9:.2f} GB HBM"
            " budget; sweeping host-resident super-rows per group",
            file=sys.stderr,
        )
        row_bytes = l_pad_s * (
            1 + eng.plan.total_channels if eng.feat_cache_on else 1
        )
        sr_rows = max(ti, (_hbm_budget() // 3 // row_bytes) // ti * ti)
        # the loaded side persists across dispatch groups: super-row
        # encodings memoize, the boundary super-row stays on device
        # (the stream fused fn takes raw codes, so no g-feature cache)
        lside = _StagedSide(eng, mat_dev_loaded, ti, diff_ref,
                            cache_g=False)
    plan = eng.plan

    pending: List[tuple] = []
    emitter = _AsyncEmitter()
    # Round-3 emission-tail machinery, stream edition: groups repeat the
    # same (bn, n1) shape, so the emission index arrays are computed once
    # per distinct bn, counter vectors recycle through the scratch pool
    # (fresh multi-GB allocs hit this VM's lazily-faulted first-touch
    # path), and the padded upload buffer is reused across groups.
    emit_idx_cache: Dict[int, tuple] = {}
    spool = _ScratchPool()
    pad_pool: List[List] = []  # [buffer2d, max_rows_ever_filled]
    # Dedicated dispatcher thread: encode + H2D + kernel enqueue run off
    # the main thread, overlapping parse, fetch, and emission.  One thread
    # keeps dispatch order (and the jit cache walk) deterministic.
    from concurrent.futures import ThreadPoolExecutor

    dispatcher = ThreadPoolExecutor(1)

    # Overlap the one-time loaded-matrix prepare H2D with stream parse:
    # queue it as the dispatcher thread's FIRST task, so the reader
    # thread and first-group assembly run concurrently with the upload.
    # Group dispatches queue behind it on
    # the same single-thread executor, so every consumer of the handle
    # sees a completed upload; the future's .result() is the ordering
    # fence and re-raises any prepare error on the consuming thread.
    if staged:
        prep_fut = None
    else:
        def _do_prepare():
            with phase_timer("stream-prepare-upload"):
                return eng.prepare(
                    mat_dev_loaded, ti, diff_ref=diff_ref, cache_g=False
                )

        prep_fut = dispatcher.submit(_do_prepare)

    def flush_one() -> None:
        (g_ord, local_ord, ids2, bcounts, offs, fut, bn, redispatch,
         pad_entry) = pending.pop(0)
        with phase_timer("stream-fetch-wait"):
            strip = _fetch_stream_batch(eng, fut.result(), n1, bn,
                                        redispatch)
        if pad_entry is not None:
            # the fetch completing proves the upload was consumed; the
            # padded buffer is free for the next group
            pad_pool.append(pad_entry)
        # Emission: for each streamed record (outer), all loaded (inner)
        # with columns (loaded_id, streamed_id) — lib.rs:322-333.
        with phase_timer("stream-gather"):
            cached = emit_idx_cache.get(bn)
            if cached is None:
                local_cols = np.repeat(np.arange(bn, dtype=np.int32), n1)
                row_idx = np.tile(np.arange(n1, dtype=np.int32), bn)
                if len(emit_idx_cache) >= 4:  # bn takes few values
                    emit_idx_cache.pop(next(iter(emit_idx_cache)))
                emit_idx_cache[bn] = (row_idx, local_cols)
            else:
                row_idx, local_cols = cached
            # streamed-major emission == the transposed (bn, n1) flat
            # view, plus each record's invariant-column contribution
            # (the variant-split offset, same value for every loaded
            # row) — one native blocked pass per counter
            lease: List[np.ndarray] = []
            counters = {
                name: _transpose_add(
                    strip[k], n1, bn,
                    offs[name][:bn] if offs is not None else None,
                    spool, lease,
                )
                for k, name in enumerate(plan.counters)
            }
        bc = None
        if setup.measure == "tn93":
            # loaded side indexed by row_idx, streamed side by local_cols
            bc = (aln.base_counts, row_idx, bcounts, local_cols)
        with phase_timer("keys"):
            if (
                setup.measure == "tn93" and bcounts is not None
                and aln.base_counts is not None
            ):
                uniq, inv = np.unique(
                    np.asarray(bcounts)[:bn], axis=0, return_inverse=True
                )
                grp_ranks = (
                    np.ascontiguousarray(inv.reshape(-1), dtype=np.int32),
                    int(uniq.shape[0]),
                )
                keys, keyspace = _tn93_value_keys(
                    counters, aln.tally_ranks(), row_idx, grp_ranks,
                    local_cols, spool, lease,
                )
            else:
                keys, keyspace = _value_keys(setup.measure, counters,
                                             width, spool, lease)
        if keys is not None:
            # deferred finalize-by-representative (see _emit_pairs): the
            # writer calls back with one row per distinct key, so the
            # per-pair value array is never materialized
            measure = setup.measure

            def values(first_rows, counters=counters, bc=bc):
                if first_rows is None:
                    with phase_timer("finalize"):
                        return finalize_block(measure, counters, bc)
                sub = {k: v[first_rows] for k, v in counters.items()}
                sbc = None
                if bc is not None:
                    bcq, iq, bct, it = bc
                    sbc = (bcq, iq[first_rows], bct, it[first_rows])
                with phase_timer("finalize"):
                    return finalize_block(measure, sub, sbc)
        else:
            with phase_timer("finalize"):
                values = finalize_block(setup.measure, counters, bc)

        def tail(ids2=ids2, row_idx=row_idx, local_cols=local_cols,
                 values=values, keys=keys, keyspace=keyspace,
                 g_ord=g_ord, local_ord=local_ord, lease=lease):
            try:
                if unit_index is not None:
                    pos0 = setup.writer.tell()
                setup.writer.rows(
                    aln.ids, ids2, row_idx, local_cols, values, keys,
                    keyspace,
                )
                if unit_index is not None:
                    unit_index.append(g_ord, setup.writer.tell() - pos0)
                    unit_index.save()
                _progress_mark(setup, local_ord + 1)
            finally:
                spool.give_all(lease)

        with phase_timer("stream-emit-wait"):
            emitter.submit(tail)

    group: List[object] = []
    group_rows = 0
    g_ordinal = 0  # global group ordinal (shard-independent)
    local_idx = 0  # this shard's completed-unit counter (resume key)

    def dispatch_group() -> None:
        nonlocal group, group_rows, g_ordinal, local_idx
        if not group:
            return
        this_global = g_ordinal
        g_ordinal += 1
        if this_global % shard_n != shard_k:
            group, group_rows = [], 0
            return
        this_local = local_idx
        local_idx += 1
        if this_local < done:
            group, group_rows = [], 0
            return
        with phase_timer("stream-group-build"):
            ids2 = [i for b in group for i in b.ids]
            bcounts = (
                np.concatenate([b.base_counts for b in group], axis=0)
                if group[0].base_counts is not None
                else None
            )
        bn = sum(b.matrix.shape[0] for b in group)
        with phase_timer("stream-upload"):
            # Fill the padded device buffer straight from the parsed
            # batches — one pass instead of concatenate + pad (two full
            # copies of a ~250 MB group and an extra transient).
            rows_pad = -(-bn // grows) * grows
            # device matrices pad the site axis to a lane multiple of
            # 128 (eng.prepare); computing it here instead of reading
            # m1.shape keeps group assembly independent of the prepare
            # upload still in flight on the dispatcher thread
            l_dev = width_dev if backend == "numpy" else l_pad_s
            # Recycle the previous group's buffer (returned to pad_pool
            # once its fetch completed): rows [0:bn) are overwritten by
            # the fill below, rows [bn:filled) carry stale data and are
            # re-zeroed, rows beyond were never written and stay zero.
            pad_entry = None
            for k, (buf, filled) in enumerate(pad_pool):
                if buf.shape[0] >= rows_pad and buf.shape[1] == l_dev:
                    pad_entry = pad_pool.pop(k)
                    padded = pad_entry[0][:rows_pad]
                    if filled > bn:
                        padded[bn:min(filled, rows_pad)] = 0
                    pad_entry[1] = max(filled, bn)
                    break
            if pad_entry is None:
                root = np.zeros((rows_pad, l_dev), dtype=np.uint8)
                pad_entry = [root, bn]
                padded = root
            offs_parts = []
            r = 0
            for b in group:
                m = b.matrix
                if split is not None:
                    offs_parts.append(split.offsets(m))
                    m = m[:, split.keep]
                padded[r : r + m.shape[0], : m.shape[1]] = m
                r += m.shape[0]
            offs = (
                {
                    k: np.concatenate([p[k] for p in offs_parts])
                    for k in offs_parts[0]
                }
                if split is not None
                else None
            )
        group, group_rows = [], 0

        if backend == "numpy":
            def dispatch(padded=padded, rows_pad=rows_pad, mode=None):
                m1 = prep_fut.result()
                return np.concatenate([
                    eng.block(m1, padded, i0, 0, ti, rows_pad, mode)
                    for i0 in range(0, n1, ti)
                ], axis=1)
        elif staged:
            def dispatch(padded=padded, rows_pad=rows_pad, mode=None,
                         bn=bn):
                return _dispatch_stream_staged(
                    eng, lside, padded, rows_pad,
                    mode, bn, n1, ti, sr_rows,
                )
        else:
            def dispatch(padded=padded, rows_pad=rows_pad, mode=None,
                         bn=bn):
                m1 = prep_fut.result()
                return eng.dispatch_stream(m1, padded, rows_pad, mode,
                                           nv=(n1, bn))

        with phase_timer("stream-dispatch"):
            fut = dispatcher.submit(
                lambda p=padded, rp=rows_pad: _start_stream_fetch(
                    dispatch(p, rp)
                )
            )
            pending.append(
                (this_global, this_local, ids2, bcounts, offs, fut, bn,
                 lambda mode, p=padded, rp=rows_pad: dispatch(p, rp, mode),
                 pad_entry)
            )
        # Bounded in-flight groups (pipelining over dispatch latency;
        # pending_cap shrinks under staging so the assembled (C, n1, bn)
        # host buffers stay within HOST_BUF_BUDGET).
        while len(pending) > pending_cap:
            flush_one()

    _SENTINEL = object()
    try:
        it = _threaded_iter(stream_fasta(
            setup.streamed, width, setup.measure, setup.consensus, user_b
        ))
        while True:
            with phase_timer("stream-parse-wait"):
                batch = next(it, _SENTINEL)
            if batch is _SENTINEL:
                break
            group.append(batch)
            group_rows += batch.matrix.shape[0]
            if group_rows >= grows:
                dispatch_group()
    except DistanceError:
        # a bad streamed record: emit every fully-read user batch first
        dispatch_group()
        while pending:
            flush_one()
        try:
            emitter.finish()
        except Exception:
            pass  # the stream error is the one to report
        finally:
            if prep_fut is not None:
                # retrieve the overlapped prepare's outcome so a failed
                # upload is not silently dropped (the stream error
                # stays the one reported)
                prep_fut.cancel()

                def _consume(f):
                    try:
                        f.exception()
                    except Exception:
                        pass

                prep_fut.add_done_callback(_consume)
            dispatcher.shutdown(wait=False)
        raise
    dispatch_group()
    while pending:
        flush_one()
    dispatcher.shutdown()
    if prep_fut is not None:
        # an empty stream never consumes the overlapped prepare; a
        # failed upload must still surface, not vanish with the thread
        prep_fut.result()
    emitter.finish()


class _StagedStrip:
    """Already-fetched (C, n1, bn) int32 counters (staged stream mode:
    the loaded side exceeded the HBM budget, so the dispatch itself
    swept host-resident super-rows and fully assembled the group)."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr


def _dispatch_stream_staged(eng: _BlockEngine, lside: _StagedSide,
                            padded: np.ndarray, rows_pad: int,
                            mode, bn: int, n1: int, ti: int,
                            sr_rows: int) -> _StagedStrip:
    """Stream-group dispatch with a host-resident loaded side.

    The reference bounds stream mode by host RAM — the loaded alignment
    plus one batch (lib.rs:269-365) — with no device-memory ceiling.
    The device analog: per dispatch group, stage loaded super-rows
    through HBM, dispatch each against the (already padded) group, and
    assemble the group's full (C, n1, bn) counters on the host.  Runs
    synchronously on the dispatcher thread (overlapping parse and
    emission on the main thread); pack-mode escalation on lane
    saturation happens per super-row.  ``lside`` persists across groups:
    each super-row's diff encoding memoizes on first staging, and with
    the serpentine order the boundary super-row stays device-resident —
    consecutive groups re-upload one fewer super-row and never repeat
    the host encode passes.
    """
    plan = eng.plan
    buf = np.empty((len(plan.counters), n1, bn), dtype=np.int32)
    # one encode + H2D for the whole group (filled by the first
    # dispatch, reused by every later super-row — the encode alone is a
    # host pass over the full group)
    h2d_cache: dict = {}
    spans = [
        (q0, min(q0 + sr_rows, n1)) for q0 in range(0, n1, sr_rows)
    ]
    m1q = None
    for q0, q1 in lside.serpentine(spans):
        # release the previous super-row's reference before the next
        # staging uploads (its fetch completed; redisp closures died)
        m1q = None
        m1q = lside.get(q0, q1)

        def redisp(m, m1q=m1q, q0=q0, q1=q1):
            return eng.dispatch_stream(m1q, padded, rows_pad, m,
                                       nv=(q1 - q0, bn),
                                       h2d_cache=h2d_cache)

        part = _fetch_stream_batch(
            eng, _start_stream_fetch(redisp(mode)), q1 - q0, bn, redisp
        )
        buf[:, q0:q1, :] = part
    return _StagedStrip(buf)


def _start_stream_fetch(out):
    """Eagerly start D2H for a stream-dispatch result (rel modes return
    a (lanes, sidecar-bundle) pair; everything else a single array)."""
    if isinstance(out, _StagedStrip):
        return out
    if isinstance(out, tuple):
        return tuple(_AsyncFetch(h, axis=1) for h in out)
    return _AsyncFetch(out, axis=1)


def _unpack_rel_parts(eng: _BlockEngine, parts, vr: int, vc: int):
    """Crop a rel-packed fetch — (lanes, bundle) with the fused sidecar
    bundle, or an unbundled (lanes, cb, rb_cc[, exc_idx, exc_val])
    tuple — to the valid region and reconstruct int32 counters.
    Returns (counters_or_None, was_rel4); counters is None on lane
    saturation (sidecar overflow under rel4).

    rel4 lanes expand to full-width residuals first: exception indices
    address the padded tensor, and a strip's sidecars are per-block
    ((B, CAP) int32, block-local flat indices into (G, ti, tj))."""
    from distance_tpu.ops.packing import (
        REL4_SAT, finish_host_rel4, unbundle_sidecars, unpack_host_rel,
        unpack_rel4_nibbles,
    )

    if len(parts) == 2:
        cb_, rb_cc_, ei, ev = unbundle_sidecars(parts[1])
        parts = (parts[0], cb_, rb_cc_) + (
            (ei, ev) if ei is not None else ()
        )
    lanes, cb, rb_cc = parts[:3]
    rb, cc = rb_cc[:, :vr], rb_cc[:, -1]
    if len(parts) == 5:
        exc_idx, exc_val = parts[3], parts[4]
        from distance_tpu._native import get_lib

        lib = get_lib()
        if (
            lib is not None
            and isinstance(lanes, np.ndarray)
            and lanes.flags.c_contiguous
        ):
            return _rel4_finish_native(
                lib, lanes, rb, cb, cc, exc_idx, exc_val, vr, vc
            ), True
        res = unpack_rel4_nibbles(lanes)  # full padded (G, rows, span)
        # -8 is saturation ONLY where no exception patches it (a patched
        # residual may legitimately be -8)
        bad = res == REL4_SAT
        flat, flatbad = res.reshape(-1), bad.reshape(-1)
        if exc_idx.ndim == 1:  # single tensor (stream group / one block)
            sel = exc_idx >= 0
            idx = exc_idx[sel]
            flat[idx] = exc_val[sel]
            flatbad[idx] = False
        else:  # (B, CAP): block-local indices into (G, ti, tj)
            g_span = res.shape[1] * res.shape[2]
            n_blocks = exc_idx.shape[0]
            tj = res.shape[2] // n_blocks
            for b in range(n_blocks):
                idx = exc_idx[b]
                sel = idx >= 0
                idx = idx[sel]
                g, rem = idx // (res.shape[1] * tj), idx % (res.shape[1] * tj)
                r, c = rem // tj, rem % tj
                pos = g * g_span + r * res.shape[2] + b * tj + c
                flat[pos] = exc_val[b][sel]
                flatbad[pos] = False
        return finish_host_rel4(
            res[:, :vr, :vc], rb, cb[:, :vc], cc, bad[:, :vr, :vc]
        ), True
    return (
        unpack_host_rel(lanes[:, :vr, :vc], rb, cb[:, :vc], cc),
        False,
    )


def _transpose_add(mat: np.ndarray, n1: int, bn: int,
                   add: Optional[np.ndarray],
                   spool: Optional[_ScratchPool] = None,
                   lease: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """(n1_pad, rows_pad)-strided counter matrix -> flat streamed-major
    (bn*n1,) int32 vector with an optional per-streamed-record offset
    added (stream variant-split).  Native blocked transpose chunked
    across the pool when available; numpy fallback otherwise.  With
    ``spool``/``lease`` the output recycles through the scratch pool
    (give_all once the emission tail is done with it)."""
    from distance_tpu._native import get_lib

    lib = get_lib()
    if (
        lib is None
        or mat.dtype != np.int32
        or mat.strides[1] != 4
        or mat.strides[0] % 4
    ):
        out = np.ascontiguousarray(mat[:n1, :bn].T).reshape(-1)
        if add is not None:
            out = out + np.repeat(add, n1)
        return out
    import ctypes

    from distance_tpu.ops.diffup import _get_pool, _row_chunks

    add_c = np.ascontiguousarray(
        add if add is not None else np.zeros(bn, dtype=np.int32),
        dtype=np.int32,
    )
    out = (
        spool.take(bn * n1, np.int32, lease)
        if spool is not None and lease is not None
        else np.empty(bn * n1, dtype=np.int32)
    )
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    in_stride = mat.strides[0] // 4
    pool = _get_pool()

    def run(span):
        c0, c1 = span
        lib.dt_transpose_add_i32(
            mat.ctypes.data_as(p_i32), n1, in_stride, c0, c1,
            add_c.ctypes.data_as(p_i32), out.ctypes.data_as(p_i32),
        )

    chunks = _row_chunks(bn, pool._max_workers)
    if len(chunks) > 1:
        list(pool.map(run, chunks))
    else:
        run(chunks[0])
    return out


def _rel4_finish_native(lib, lanes, rb, cb, cc, exc_idx, exc_val,
                        vr: int, vc: int):
    """Native rel4 finish: one GIL-released C pass per row chunk expands
    the nibble lanes, applies the rank-1 baseline, and counts -8
    sentinels in the cropped region; exception positions are then
    patched vectorized on host (each was emitted as a sentinel, so
    sentinels minus patched positions = genuine saturations).  Returns
    (G, vr, vc) int32 counters, or None on saturation (caller refetches).
    Bit-identical to the numpy path (tests/test_packing.py)."""
    import ctypes

    from distance_tpu.ops.diffup import _get_pool, _row_chunks

    g_n, rows, ch = lanes.shape
    out = np.empty((g_n, vr, vc), dtype=np.int32)
    rb_c = np.ascontiguousarray(rb, dtype=np.int32)         # (G, vr)
    cb_c = np.ascontiguousarray(cb[:, :vc], dtype=np.int32)  # (G, vc)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    pool = _get_pool()
    chunks = _row_chunks(vr, pool._max_workers)

    def run(task):
        g, (r0, r1) = task
        return lib.dt_rel4_expand_add(
            lanes[g].ctypes.data_as(p_i8), ch, r0, r1,
            rb_c[g].ctypes.data_as(p_i32), cb_c[g].ctypes.data_as(p_i32),
            ctypes.c_int32(int(cc[g])), vc,
            out[g].ctypes.data_as(p_i32),
        )

    tasks = [(g, span) for g in range(g_n) for span in chunks]
    sent = sum(pool.map(run, tasks) if len(tasks) > 1 else [run(tasks[0])])

    patched = 0
    ei = exc_idx if exc_idx.ndim == 2 else exc_idx[None]
    ev = exc_val if exc_val.ndim == 2 else exc_val[None]
    span_res = 2 * ch
    tj = span_res // ei.shape[0]
    for b in range(ei.shape[0]):
        idx = ei[b]
        sel = idx >= 0
        idx = idx[sel].astype(np.int64)
        if not idx.size:
            continue
        g = idx // (rows * tj)
        rem = idx % (rows * tj)
        r, c = rem // tj, rem % tj
        gcol = b * tj + c
        m = (r < vr) & (gcol < vc)
        g, r, gcol = g[m], r[m], gcol[m]
        out[g, r, gcol] = (
            ev[b][sel][m] + rb_c[g, r] + cb_c[g, gcol] - cc[g]
        )
        patched += int(m.sum())
    if sent - patched:
        return None
    return out


def _rel_wide_refetch(eng: _BlockEngine, redispatch, vr: int, vc: int,
                      axis: int, try_rel: bool = False) -> np.ndarray:
    """Re-dispatch a saturated rel-family fetch.  A rel4 saturation first
    tries the adjacent int8 rel rung (1 B/counter — nibble outliers are
    almost always within int8 range); only a rel saturation pays the
    wide (or raw-int32) refetch."""
    if try_rel and eng.rel_ref is not None:
        parts = tuple(np.asarray(a) for a in redispatch("rel"))
        counters, _ = _unpack_rel_parts(eng, parts, vr, vc)
        eng.note_rel(counters is None)  # the ladder must see rel failing
        if counters is not None:
            return counters
    wide = redispatch("wide" if eng.packed else "none")
    arr = _chunked_d2h(wide, axis=axis)[:, :vr, :vc]
    if not eng.packed:
        return arr
    from distance_tpu.ops.packing import unpack_host

    return unpack_host(eng.measure, arr)


def _fetch_stream_batch(eng: _BlockEngine, handle, valid_rows: int,
                        valid_cols: int, redispatch) -> np.ndarray:
    """Chunked fetch of a streamed batch's (P, n1_pad, batch) counters."""
    if isinstance(handle, _StagedStrip):
        return handle.arr
    if isinstance(handle, tuple):
        parts = tuple(h.result() for h in handle)
        return _finish_fetched(
            eng, parts, valid_rows, valid_cols, redispatch, axis=1
        )
    arr = handle.result() if isinstance(handle, _AsyncFetch) else handle
    if eng.backend == "numpy":
        return arr
    return _finish_fetched(
        eng, arr, valid_rows, valid_cols, redispatch, axis=1
    )


def _threaded_iter(it, maxsize: int = 64):
    """Run an iterator in a background thread (bounded queue).

    The reference's stream reader is its own thread (lib.rs:288-306); this
    overlaps FASTA parse+encode with device dispatch and emission.  An
    exception from the source is re-raised here only after every earlier
    item has been consumed — preserving the mid-stream-error contract
    (all fully-read batches are emitted first).
    """
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
    sentinel = object()

    def run() -> None:
        try:
            for item in it:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item

