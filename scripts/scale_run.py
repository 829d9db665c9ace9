"""Scale harness: a 100k-seq x ~30kb out-of-core sweep on real hardware.

Runs the full product path (FASTA on disk -> CLI -> blocked out-of-core
sweep -> TSV with --resume live), interrupting the run once mid-way to
exercise resume, and reports sustained pairs/s plus peak host RSS.

    python scripts/scale_run.py [N_SEQS] [WIDTH] [HBM_BUDGET_BYTES]

Defaults: 100000 x 29904, 1.5 GB HBM budget (forces the blocked sweep
for the 3 GB packed matrix).  Needs ~90 GB free disk for the TSV; the
output is validated (row count + random row spot checks vs the oracle)
and deleted at the end.  Progress + phase logs go to stderr.

Env knobs: SCALE_MEASURE (default n_high), SCALE_SKIP_KILL (skip the
kill+resume phase for a clean completion-to-completion measurement),
SCALE_KILL_AFTER_S, SCALE_DIR, SCALE_MUT_WINDOW (confine variation to
the first K columns so invariant-column pruning engages — at >=20k
seqs, genome-wide random mutation leaves no column invariant, which is
unrealistic: most of a real SARS-CoV-2 alignment is conserved).
"""

import os
import random
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def write_fasta(path: str, n: int, width: int) -> np.ndarray:
    from bench import make_alignment
    from distance_tpu.encoding import CODE_TO_CHAR

    mat = make_alignment(n, width)
    win = int(os.environ.get("SCALE_MUT_WINDOW", "0"))
    if win:
        # columns past the window revert to a shared (invariant) value
        mat[:, win:] = mat[0, win:]
    table = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        table[code] = ord(ch)
    t0 = time.time()
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b">s%d\n" % i)
            f.write(table[mat[i]].tobytes())
            f.write(b"\n")
    print(f"[scale] wrote {path} ({os.path.getsize(path)/1e9:.2f} GB)"
          f" in {time.time()-t0:.0f}s", file=sys.stderr)
    return mat


def peak_rss_gb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def run_child(args, env, out_path, kill_after_s=None):
    """Run the CLI; sample output growth; return (rc, peak_rss, samples)."""
    child = subprocess.Popen(args, env=env)
    samples = []
    peak = 0.0
    t0 = time.time()
    while child.poll() is None:
        time.sleep(2)
        peak = max(peak, peak_rss_gb(child.pid))
        try:
            samples.append((time.time() - t0, os.path.getsize(out_path)))
        except OSError:
            pass
        if kill_after_s and time.time() - t0 > kill_after_s:
            child.kill()
            child.wait()
            return None, peak, samples
    return child.returncode, peak, samples


def _oracle(measure):
    """(row-pair -> formatted string) oracle for spot checks."""
    from distance_tpu import measures
    from distance_tpu.writer import format_float

    if measure in ("n", "n_high"):
        return lambda a, b: str(measures.snp(a, b))
    if measure == "tn93":
        from distance_tpu.encoding import A, C, G, T

        def counts(row):
            return tuple(int((row == v).sum()) for v in (A, T, G, C))

        return lambda a, b: format_float(
            float(measures.tn93(a, b, counts(a), counts(b)))
        )
    fn = getattr(measures, measure)
    return lambda a, b: format_float(float(fn(a, b)))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    width = int(sys.argv[2]) if len(sys.argv) > 2 else 29_904
    budget = int(sys.argv[3]) if len(sys.argv) > 3 else 1_500_000_000
    measure = os.environ.get("SCALE_MEASURE", "n_high")
    work = os.environ.get("SCALE_DIR", "/tmp/scale_run")
    os.makedirs(work, exist_ok=True)
    fasta = os.path.join(work, "big.fasta")
    out = os.path.join(work, "out.tsv")

    mat = write_fasta(fasta, n, width)
    value_of = _oracle(measure)

    env = dict(
        os.environ,
        DISTANCE_TPU_HBM_BUDGET=str(budget),
        DISTANCE_TPU_PROGRESS="1",
    )
    argv = [sys.executable, "-m", "distance_tpu.cli", fasta, "-m",
            measure, "--backend", "xla", "--resume", "-o", out]

    if os.environ.get("SCALE_SKIP_KILL"):
        # clean completion-to-completion measurement, no kill+resume
        size_at_kill, peak1 = 0, 0.0
    else:
        kill_after = float(os.environ.get("SCALE_KILL_AFTER_S", 300))
        print(f"[scale] phase 1: run until t={kill_after:.0f}s, then kill",
              file=sys.stderr)
        rc, peak1, s1 = run_child(argv, env, out, kill_after_s=kill_after)
        assert rc is None, f"finished before the kill point (rc={rc})"
        if not os.path.exists(out + ".progress"):
            print("[scale] warning: killed before the first checkpoint;"
                  " phase 2 restarts from scratch", file=sys.stderr)
        size_at_kill = os.path.getsize(out) if os.path.exists(out) else 0
        print(f"[scale] killed at {size_at_kill/1e9:.2f} GB output,"
              f" peak RSS {peak1:.1f} GB", file=sys.stderr)

    print("[scale] phase 2: --resume to completion", file=sys.stderr)
    t0 = time.time()
    rc, peak2, s2 = run_child(argv, env, out)
    wall2 = time.time() - t0
    assert rc == 0, f"resume run failed rc={rc}"

    total_pairs = n * (n - 1) // 2
    total_bytes = os.path.getsize(out)
    # sustained rate over the resumed window (excludes load+encode by
    # using the growth samples after output started moving)
    moving = [(t, b) for t, b in s2 if b > size_at_kill + 1]
    if len(moving) >= 2:
        (ta, ba), (tb, bb) = moving[0], moving[-1]
        bytes_per_row = total_bytes / (total_pairs + 1)
        sustained = (bb - ba) / bytes_per_row / (tb - ta)
    else:
        sustained = float("nan")

    # validate: row count + random row spot checks
    print("[scale] validating", file=sys.stderr)
    import mmap

    with open(out, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header_end = mm.find(b"\n") + 1
        rng = random.Random(7)
        checked = 0
        # exact prefix: the first rows in canonical order (all i=0)
        pos = header_end
        for j in range(1, min(n, 400)):
            end = mm.find(b"\n", pos)
            sid1, sid2, val = mm[pos:end].decode().split("\t")
            assert (sid1, sid2) == ("s0", f"s{j}"), (sid1, sid2, j)
            assert val == value_of(mat[0], mat[j]), (j, val)
            pos = end + 1
            checked += 1
        # random byte offsets: parse the row found there, verify value
        for _ in range(50):
            off = rng.randrange(header_end, len(mm) - 2)
            pos = mm.find(b"\n", off) + 1
            if pos >= len(mm):
                continue
            end = mm.find(b"\n", pos)
            if end < 0:
                continue
            sid1, sid2, val = mm[pos:end].decode().split("\t")
            i, j = int(sid1[1:]), int(sid2[1:])
            assert val == value_of(mat[i], mat[j]), (i, j, val)
            checked += 1
        # total line count via byte statistics is unreliable; count
        # newlines in chunks
        mm.seek(0)
        lines = 0
        CH = 1 << 26
        for off in range(0, len(mm), CH):
            lines += mm[off : off + CH].count(b"\n")
        mm.close()
    assert lines == total_pairs + 1, (lines, total_pairs + 1)

    result = {
        "n_seqs": n,
        "width": width,
        "measure": measure,
        "total_pairs": total_pairs,
        "output_gb": round(total_bytes / 1e9, 2),
        "sustained_pairs_per_s": round(sustained, 1),
        "resume_wall_s": round(wall2, 1),
        "peak_rss_gb": round(max(peak1, peak2), 2),
        "hbm_budget_gb": round(budget / 1e9, 2),
        "spot_checks": checked,
    }
    import json

    print(json.dumps(result))
    for p in (fasta, out):
        try:
            os.remove(p)
        except OSError:
            pass


if __name__ == "__main__":
    main()
