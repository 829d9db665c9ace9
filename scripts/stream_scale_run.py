"""Scale harness: stream 1M seqs x ~30kb against a loaded alignment.

The reference's stream mode exists to scale the *number of sequences* to
millions while memory stays bounded by the loaded alignment plus one
in-flight batch (/root/reference/src/fastaio.rs:215-286, lib.rs:269-365).
This harness runs the full product path at that design point: a 30 GB
on-disk FASTA streamed by the CLI against a 2k-seq loaded alignment on
the real chip, with --resume live and a mid-run kill, then validates the
TSV (row count, canonical order, random value spot checks vs the serial
oracle).

    python scripts/stream_scale_run.py [N_LOADED] [N_STREAM] [WIDTH]

Defaults: 2000 loaded x 1,000,000 streamed x 29904 sites = 2.0 B pairs,
~38 GB TSV + ~30 GB FASTA on disk (both deleted at the end).
"""

import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from scripts.scale_run import peak_rss_gb, run_child  # noqa: E402

CHUNK = 8192


def _char_table():
    from distance_tpu.encoding import CODE_TO_CHAR

    table = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        table[code] = ord(ch)
    return table


def stream_chunk(chunk_idx: int, n: int, width: int, ancestor) -> np.ndarray:
    """Deterministic per-chunk generation (same diversity profile as
    bench.make_alignment) so any record can be regenerated for
    validation without holding 30 GB in RAM."""
    from distance_tpu.encoding import A, C, G, T, N, GAP

    rng = np.random.default_rng(1_000_003 + chunk_idx)
    bases = np.array([A, C, G, T], dtype=np.uint8)
    mat = np.tile(ancestor, (n, 1))
    n_mut = 40
    rows = np.repeat(np.arange(n), n_mut)
    cols = rng.integers(0, width, size=n * n_mut)
    mat[rows, cols] = rng.choice(bases, size=n * n_mut)
    n_amb = max(1, int(0.005 * n * width))
    rows = rng.integers(0, n, size=n_amb)
    cols = rng.integers(0, width, size=n_amb)
    mat[rows, cols] = np.where(
        rng.random(n_amb) < 0.8, N, GAP
    ).astype(np.uint8)
    return mat


def streamed_record(r: int, width: int, ancestor, cache={}) -> np.ndarray:
    ci, off = divmod(r, CHUNK)
    if cache.get("idx") != ci:
        cache["idx"] = ci
        cache["mat"] = stream_chunk(ci, CHUNK, width, ancestor)
    return cache["mat"][off]


def write_stream_fasta(path: str, n: int, width: int, ancestor) -> None:
    table = _char_table()
    t0 = time.time()
    with open(path, "wb", buffering=1 << 22) as f:
        for c0 in range(0, n, CHUNK):
            cn = min(CHUNK, n - c0)
            # always generate the full chunk so regeneration for
            # validation (streamed_record) draws identical randomness
            mat = stream_chunk(c0 // CHUNK, CHUNK, width, ancestor)[:cn]
            chars = table[mat]
            f.write(b"".join(
                b">q%07d\n%s\n" % (c0 + i, chars[i].tobytes())
                for i in range(cn)
            ))
    print(f"[stream-scale] wrote {path} ({os.path.getsize(path)/1e9:.2f} GB)"
          f" in {time.time()-t0:.0f}s", file=sys.stderr)


def main():
    n1 = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000
    n2 = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    width = int(sys.argv[3]) if len(sys.argv) > 3 else 29_904
    work = os.environ.get("SCALE_DIR", "/tmp/stream_scale")
    os.makedirs(work, exist_ok=True)
    loaded_fa = os.path.join(work, "loaded.fasta")
    stream_fa = os.path.join(work, "big.fasta")
    out = os.path.join(work, "out.tsv")

    from bench import make_alignment
    from distance_tpu.encoding import A, C, G, T

    # the loaded alignment and the streamed ancestor share one profile
    loaded_mat = make_alignment(n1, width, seed=1)
    rng = np.random.default_rng(999)
    ancestor = rng.choice(
        np.array([A, C, G, T], dtype=np.uint8), size=width
    )
    table = _char_table()
    with open(loaded_fa, "wb") as f:
        for i in range(n1):
            f.write(b">s%d\n%s\n" % (i, table[loaded_mat[i]].tobytes()))
    if not os.path.exists(stream_fa) or os.environ.get("SCALE_REGEN"):
        write_stream_fasta(stream_fa, n2, width, ancestor)

    env = dict(os.environ, DISTANCE_TPU_PROGRESS="1")
    backend = os.environ.get("SCALE_BACKEND", "xla")
    argv = [sys.executable, "-m", "distance_tpu.cli", "-i", loaded_fa,
            "-s", stream_fa, "-m", "n_high", "--backend", backend,
            "--resume", "-o", out]

    if os.environ.get("SCALE_SKIP_KILL"):
        # clean completion-to-completion measurement, no kill+resume
        size_at_kill, peak1 = 0, 0.0
    else:
        kill_after = float(os.environ.get("SCALE_KILL_AFTER_S", 240))
        print(f"[stream-scale] phase 1: run until t={kill_after:.0f}s,"
              " kill", file=sys.stderr)
        rc, peak1, s1 = run_child(argv, env, out, kill_after_s=kill_after)
        assert rc is None, f"finished before the kill point (rc={rc})"
        size_at_kill = os.path.getsize(out) if os.path.exists(out) else 0
        print(f"[stream-scale] killed at {size_at_kill/1e9:.2f} GB output,"
              f" peak RSS {peak1:.1f} GB", file=sys.stderr)

    print("[stream-scale] phase 2: --resume to completion", file=sys.stderr)
    t0 = time.time()
    rc, peak2, s2 = run_child(argv, env, out)
    wall2 = time.time() - t0
    assert rc == 0, f"resume run failed rc={rc}"

    total_pairs = n1 * n2
    total_bytes = os.path.getsize(out)
    moving = [(t, b) for t, b in s2 if b > size_at_kill + 1]
    if len(moving) >= 2:
        (ta, ba), (tb, bb) = moving[0], moving[-1]
        bytes_per_row = total_bytes / (total_pairs + 1)
        sustained = (bb - ba) / bytes_per_row / (tb - ta)
    else:
        sustained = float("nan")

    print("[stream-scale] validating", file=sys.stderr)
    import mmap

    from distance_tpu import measures

    with open(out, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header_end = mm.find(b"\n") + 1
        checked = 0
        # exact prefix: streamed record 0 vs loaded rows in order
        # (stream rows are (loaded_id, streamed_id), loaded-major within
        # one streamed record — lib.rs:322-333)
        pos = header_end
        rec0 = streamed_record(0, width, ancestor)
        for i in range(min(n1, 400)):
            end = mm.find(b"\n", pos)
            sid1, sid2, val = mm[pos:end].decode().split("\t")
            assert (sid1, sid2) == (f"s{i}", "q0000000"), (sid1, sid2, i)
            assert int(val) == measures.snp(loaded_mat[i], rec0), (i, val)
            pos = end + 1
            checked += 1
        # random offsets: regenerate the streamed record, verify value
        rnd = random.Random(7)
        for _ in range(60):
            off = rnd.randrange(header_end, len(mm) - 2)
            pos = mm.find(b"\n", off) + 1
            if pos >= len(mm):
                continue
            end = mm.find(b"\n", pos)
            if end < 0:
                continue
            sid1, sid2, val = mm[pos:end].decode().split("\t")
            i, r = int(sid1[1:]), int(sid2[1:])
            want = measures.snp(
                loaded_mat[i], streamed_record(r, width, ancestor)
            )
            assert int(val) == want, (i, r, val, want)
            checked += 1
        lines = 0
        CH = 1 << 26
        for off in range(0, len(mm), CH):
            lines += mm[off:off + CH].count(b"\n")
        mm.close()
    assert lines == total_pairs + 1, (lines, total_pairs + 1)

    result = {
        "n_loaded": n1,
        "n_streamed": n2,
        "width": width,
        "total_pairs": total_pairs,
        "output_gb": round(total_bytes / 1e9, 2),
        "fasta_gb": round(os.path.getsize(stream_fa) / 1e9, 2),
        "sustained_pairs_per_s": round(sustained, 1),
        "resume_wall_s": round(wall2, 1),
        "peak_rss_gb": round(max(peak1, peak2), 2),
        "spot_checks": checked,
    }
    print(json.dumps(result))
    if not os.environ.get("SCALE_KEEP"):
        for p in (loaded_fa, stream_fa, out):
            try:
                os.remove(p)
            except OSError:
                pass


if __name__ == "__main__":
    main()
