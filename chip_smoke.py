#!/usr/bin/env python3
"""Smoke test of the ``distance`` engine on one NVIDIA GPU.

Runs the main path through the user's entry points at SARS-CoV-2 width
(29,904 sites) and checks every output against the repository's plain
references:

1. device: JAX's device list, and the card's name and power limit;
2. kernel: the int8 counter GEMM of all six measures, compiled for the
   card, compared exactly with the NumPy counters; which GEMM
   implementation XLA chose for each contraction;
3. gemm: the cached-feature contraction's int8 rate on raw blocks of
   8192 x 8192 and 4096 x 4096;
4. main: the ``distance`` CLI on 8,192 x 29,904 for raw and tn93, with
   random rows spot-checked against ``measures.py``;
5. modes: stream, two-file rectangle and out-of-core square runs,
   spot-checked the same way;
6. parity: all six measures on an ambiguity-rich fixture, square,
   rectangle and stream, ``--backend xla`` byte-compared with
   ``--backend numpy``.

Usage (from the repository root):

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --four-cards  # four cards: the sharded sweep only

The parent process never imports JAX.  Each phase runs in its own child
process with ``JAX_PLATFORMS=cuda``, one after another, so only one
process holds the card at a time; the children share the persistent
compile cache (utils/jitcache.py).  Any failed phase exits non-zero and
prints no result.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH = 29_904
MEASURES = ("n", "n_high", "raw", "jc69", "k80", "tn93")
SPOT_ROWS = 400
KERNEL_ROWS = (256, 512)        # phase 2: the compared slice
GEMM_EDGES = (8192, 4096)       # phase 3: raw block edges
N_MAIN = 8192                   # phases 4 and four-cards: square sweep
N_MODES = 12_000                # phase 5: out-of-core square
N_LOADED = 2000                 # phase 5: stream, loaded side
N_RECT = 4096                   # phase 5: rectangle edge
OOC_BUDGET = 256 << 20          # phase 5: below the 0.37 GB of padded codes
PARITY_SHAPE = (400, 250, 310)  # phase 6: rows of A, rows of B, width
RESULT_TAG = "PHASE_RESULT "
# The whole run must end within 1200 s, compilation included; no phase
# may start a child that could outlive this.
DEADLINE_S = 1150.0
_T0 = time.monotonic()


# ---------------------------------------------------------------------------
# Parent: phase orchestration (no JAX here)
# ---------------------------------------------------------------------------

def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cuda"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    env.update(extra)
    return env


def run_phase(name: str, workdir: str, timeout: float, **env_extra) -> dict:
    """Run one phase in a child process; pass its output on; return the
    dict it reports.  A failed child ends the whole run."""
    t0 = time.perf_counter()
    left = DEADLINE_S - (time.monotonic() - _T0)
    if left < 30:
        raise SystemExit(f"no time left for phase {name}")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", name,
         "--workdir", workdir],
        env=_child_env(**env_extra), cwd=REPO, stdout=subprocess.PIPE,
        text=True, timeout=min(timeout, left),
    )
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT_TAG):
            result = json.loads(line[len(RESULT_TAG):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        raise SystemExit(
            f"phase {name} failed (exit {proc.returncode})"
        )
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded sweep and its"
                    " one-card comparison")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return run_child_phase(args.phase, args.workdir)
    if not os.path.isdir(os.path.join(REPO, "distance_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            device = four_cards(workdir)
        else:
            device = one_card(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


def one_card(workdir: str) -> dict:
    dev = run_phase("device", workdir, 120)
    run_phase("kernel", workdir, 420)
    run_phase("gemm", workdir, 240)
    run_phase("main", workdir, 420)
    run_phase("modes", workdir, 600)
    run_phase("parity", workdir, 300)
    return dev["device"]


def four_cards(workdir: str) -> dict:
    four = run_phase("sweep4", workdir, 420)
    one = run_phase("sweep4", workdir, 420, CUDA_VISIBLE_DEVICES="0")
    if four["device"]["count"] != 4 or one["device"]["count"] != 1:
        raise SystemExit(
            f"expected 4 and 1 devices, got {four['device']['count']}"
            f" and {one['device']['count']}"
        )
    same = _same_bytes(four["tsv"], one["tsv"])
    print(f"[four-cards] 4-card wall {four['wall_s']:.2f} s,"
          f" 1-card wall {one['wall_s']:.2f} s, TSVs byte-identical:"
          f" {same}")
    if not same:
        raise SystemExit("four-card TSV differs from the one-card TSV")
    return four["device"]


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


# ---------------------------------------------------------------------------
# Children
# ---------------------------------------------------------------------------

def run_child_phase(name: str, workdir: str) -> int:
    phase = {
        "device": phase_device,
        "kernel": phase_kernel,
        "gemm": phase_gemm,
        "main": phase_main,
        "modes": phase_modes,
        "parity": phase_parity,
        "sweep4": phase_sweep4,
    }[name]
    result = phase(workdir) or {}
    print(RESULT_TAG + json.dumps(result), flush=True)
    return 0


def require_gpu(devices) -> dict:
    """The device summary, or SystemExit unless JAX found a GPU."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found (JAX device platform: {kind})")
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _device_report() -> dict:
    import jax

    dev = require_gpu(jax.devices())
    print(f"[device] jax.devices(): {jax.devices()}")
    print(f"[device] device_kind: {dev['kind']}, count: {dev['count']}")
    print("[device] nvidia-smi --query-gpu=name,power.limit:")
    print(_smi())
    return dev


def phase_device(workdir):
    return {"device": _device_report()}


def _codes(n: int, width: int, seed: int):
    """Ambiguity-rich random code matrix (every Paradis code)."""
    import numpy as np

    from distance_tpu.encoding import ALL_CODES

    rng = np.random.default_rng(seed)
    return rng.choice(ALL_CODES, size=(n, width)).astype(np.uint8)


def _numpy_counters(measure, x, y):
    from distance_tpu.engine import _counters_numpy
    from distance_tpu.ops.features import get_plan

    return _counters_numpy(x, y, get_plan(measure))


def gemm_implementations(hlo: str) -> list:
    """What each contraction in optimized GPU HLO compiled to: a cuBLAS
    or cuBLASLt custom call, a Triton GEMM fusion, or a dot left inside
    a loop/input fusion (XLA's own emitter)."""
    found = []
    fusion_kind = {}
    for line in hlo.splitlines():
        if "fusion(" in line and "calls=" in line:
            callee = line.split("calls=")[1].split(",")[0].strip()
            kind = line.split("kind=")[1].split(",")[0] if "kind=" in line \
                else "?"
            if '"kind":"' in line:  # the GPU backend's fusion kind
                kind += " " + line.split('"kind":"')[1].split('"')[0]
            fusion_kind[callee.lstrip("%")] = kind
    comp = None
    for line in hlo.splitlines():
        s = line.strip()
        if s.endswith("{") and "(" in s and "=" not in s.split("(")[0]:
            comp = s.split()[0].lstrip("%")
            if comp == "ENTRY":
                comp = s.split()[1].lstrip("%")
        if "custom_call_target=\"__cublas" in s:
            target = s.split("custom_call_target=\"")[1].split("\"")[0]
            shape = s.split("=", 1)[1].split("custom-call(")[0].strip()
            found.append(f"cuBLAS custom call {target} -> {shape}")
        elif " dot(" in s:
            shape = s.split("=", 1)[1].split("dot(")[0].strip()
            where = fusion_kind.get(comp, "unfused")
            found.append(f"dot -> {shape} in {comp} ({where})")
    return found


def big_copies(hlo: str, min_bytes: int) -> list:
    """Transposes/copies in the optimized HLO whose result is at least
    ``min_bytes`` (a layout change XLA inserted before a GEMM)."""
    import re

    sizes = {"s8": 1, "u8": 1, "pred": 1, "s16": 2, "bf16": 2, "f16": 2,
             "s32": 4, "u32": 4, "f32": 4, "s64": 8, "f64": 8}
    out = []
    for line in hlo.splitlines():
        s = line.strip()
        if not (" transpose(" in s or " copy(" in s):
            continue
        m = re.search(r"= (\w+)\[([\d,]*)\]", s)
        if not m or m.group(1) not in sizes:
            continue
        n = sizes[m.group(1)]
        for d in filter(None, m.group(2).split(",")):
            n *= int(d)
        if n >= min_bytes:
            out.append(f"{s.split('=')[0].strip()}: {m.group(0)[2:]}"
                       f" ({n / 1e9:.2f} GB)")
    return out


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: none"
    return (
        f"memory_analysis: arguments {ma.argument_size_in_bytes / 1e6:.1f}"
        f" MB, outputs {ma.output_size_in_bytes / 1e6:.1f} MB,"
        f" temporaries {ma.temp_size_in_bytes / 1e6:.1f} MB,"
        f" code {ma.generated_code_size_in_bytes / 1e3:.0f} kB"
    )


def phase_kernel(workdir):
    """Counter GEMM of all six measures compiled for the card at width
    29,904, compared exactly with the NumPy counters."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    import jax
    import jax.numpy as jnp
    import numpy as np

    from distance_tpu.ops.features import get_plan
    from distance_tpu.ops.pairwise_xla import counters_xla
    from distance_tpu.utils.jitcache import enable_jit_cache

    require_gpu(jax.devices())
    enable_jit_cache()
    x = _codes(KERNEL_ROWS[0], WIDTH, seed=1)
    y = _codes(KERNEL_ROWS[1], WIDTH, seed=2)
    print("[kernel] precision: int8 x int8 operands, int32 accumulation"
          " (preferred_element_type=int32); counters are integers, the"
          " comparison is exact")
    # the NumPy references take tens of seconds each: compute them in
    # worker processes (no device use) while the card compiles
    pool = ProcessPoolExecutor(
        len(MEASURES), mp_context=multiprocessing.get_context("spawn")
    )
    refs = {m: pool.submit(_numpy_counters, m, x, y) for m in MEASURES}
    xd, yd = jnp.asarray(x), jnp.asarray(y)
    mismatches = []
    try:
        for m in MEASURES:
            plan = get_plan(m)
            fn = jax.jit(lambda a, b, plan=plan: counters_xla(a, b, plan))
            compiled = fn.lower(xd, yd).compile()
            hlo = compiled.as_text()
            if "s8[" not in hlo or "s32[" not in hlo:
                raise SystemExit(f"{m}: expected s8 x s8 -> s32 GEMMs")
            got = np.asarray(compiled(xd, yd))
            want = refs[m].result()
            same = got.shape == want.shape and np.array_equal(got, want)
            print(f"[kernel] {m}: {plan.total_channels} channels,"
                  f" counters {got.shape} exact match: {same}")
            print(f"[kernel] {m}: {_memory_line(compiled)}")
            for impl in gemm_implementations(hlo):
                print(f"[kernel] {m}: {impl}")
            if not same:
                mismatches.append(m)
    finally:
        pool.shutdown()
    if mismatches:
        raise SystemExit(f"counter mismatch for {mismatches}")
    return {}


def phase_gemm(workdir):
    """Steady-state int8 rate of the cached-feature contraction (the
    path _jit_block_fn_feat takes) on one raw block."""
    import jax
    import numpy as np

    import distance_tpu.engine as engine
    from distance_tpu.ops.features import get_plan
    from distance_tpu.ops.pairwise_xla import contract_features
    from distance_tpu.utils.jitcache import enable_jit_cache

    require_gpu(jax.devices())
    enable_jit_cache()
    smi = _smi()
    plan = get_plan("raw")
    r = plan.total_channels
    l_pad = -(-WIDTH // 128) * 128
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[gemm] device bytes_limit {stats.get('bytes_limit', 0) / 1e9:.2f}"
          f" GB; derived HBM budget {engine._hbm_budget() / 1e9:.2f} GB,"
          f" featcache budget {engine._featcache_budget() / 1e9:.2f} GB"
          f" (share {engine.DEVICE_BUDGET_SHARE})")
    rates = {}
    for edge in GEMM_EDGES:
        codes = np.zeros((edge, l_pad), dtype=np.uint8)
        codes[:, :WIDTH] = _codes(edge, WIDTH, seed=3)
        dev = jax.device_put(codes)
        fx = engine._jit_feat_builder("raw", "f")(dev)
        gy = engine._jit_feat_builder("raw", "g")(dev)
        fn = jax.jit(lambda a, b: contract_features(a, b, plan))
        compiled = fn.lower(fx, gy).compile()
        hlo = compiled.as_text()
        if edge == GEMM_EDGES[0]:
            print(f"[gemm] {edge}^2: {_memory_line(compiled)}")
            for impl in gemm_implementations(hlo):
                print(f"[gemm] {edge}^2: {impl}")
            for c in big_copies(hlo, 1 << 28):
                print(f"[gemm] {edge}^2: layout copy {c}")
        out = compiled(fx, gy)
        np.asarray(out[:1, :1, :1])  # warm-up, fenced by a host fetch
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(fx, gy)
        np.asarray(out[:1, :1, :1])
        dt = (time.perf_counter() - t0) / reps
        ops = 2.0 * r * edge * edge * l_pad
        rates[edge] = ops / dt
        print(f"[gemm] raw {edge}x{edge}x{l_pad} ({r} channels):"
              f" {dt * 1e3:.2f} ms per block, {ops / dt / 1e12:.1f} int8"
              f" TOP/s, {edge * edge / dt / 1e6:.0f} M pairs/s ({smi})")
        del fx, gy, dev, out
    big, small = GEMM_EDGES
    print(f"[gemm] {small}^2 rate is {rates[small] / rates[big]:.2f}x the"
          f" {big}^2 rate")
    return {}


# -- phases 4-5: the CLI in a child process, spot checks here --------------

def _write_fasta(path: str, mat, prefix: str) -> None:
    import numpy as np

    from distance_tpu.encoding import CODE_TO_CHAR

    table = np.zeros(256, dtype=np.uint8)
    for code, ch in CODE_TO_CHAR.items():
        table[code] = ord(ch)
    chars = table[mat]
    with open(path, "wb") as f:
        for i in range(mat.shape[0]):
            f.write(b">%s%d\n" % (prefix.encode(), i))
            f.write(chars[i].tobytes())
            f.write(b"\n")


def _alignment(n: int, seed: int):
    from bench import make_alignment

    return make_alignment(n, WIDTH, seed=seed)


def _run_cli(tag: str, argv: list, **env) -> tuple:
    """Run ``distance`` as its own process (the only one on the card);
    return (wall seconds, stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distance_tpu.cli"] + argv,
        env=dict(os.environ, **env), stderr=subprocess.PIPE, text=True,
        timeout=400,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"{tag}: distance exited {proc.returncode}")
    return wall, proc.stderr


def spot_check(tag, tsv, n_rows, row_of, pair_of, mat1, mat2, ids, measure,
               seed):
    """Verify the row count and SPOT_ROWS random rows of ``tsv``.

    ``row_of(k)`` maps a random draw to ``(i, j)``; ``pair_of(i, j)`` is
    the TSV line holding that pair; ``ids(i, j)`` the two expected id
    columns."""
    import mmap

    import numpy as np

    from scripts.scale_run import _oracle

    value_of = _oracle(measure)
    rng = np.random.default_rng(seed)
    with open(tsv, "rb") as f, mmap.mmap(
        f.fileno(), 0, access=mmap.ACCESS_READ
    ) as mm:
        ends = np.flatnonzero(np.frombuffer(mm, dtype=np.uint8) == 10)
        if len(ends) != n_rows + 1:
            raise SystemExit(
                f"{tag}: {len(ends)} lines, expected {n_rows + 1}"
            )
        bad = 0
        for k in range(SPOT_ROWS):
            i, j = row_of(rng)
            line = pair_of(i, j)
            start = ends[line - 1] + 1
            got = mm[start:ends[line]].decode().split("\t")
            want = list(ids(i, j)) + [value_of(mat1[i], mat2[j])]
            if got != want:
                bad += 1
                if bad <= 5:
                    print(f"[{tag}] MISMATCH line {line}: {got} != {want}")
    print(f"[{tag}] {n_rows} rows; spot-checked {SPOT_ROWS} random rows,"
          f" {bad} mismatches")
    if bad:
        raise SystemExit(f"{tag}: {bad} spot-check mismatches")


def _square_check(tag, tsv, mat, measure, seed):
    n = mat.shape[0]

    def row_of(rng):
        i, j = sorted(rng.choice(n, size=2, replace=False))
        return int(i), int(j)

    spot_check(
        tag, tsv, n * (n - 1) // 2, row_of,
        lambda i, j: 1 + i * (2 * n - i - 1) // 2 + (j - i - 1),
        mat, mat, lambda i, j: (f"s{i}", f"s{j}"), measure, seed,
    )


def phase_main(workdir):
    n = N_MAIN
    mat = _alignment(n, seed=0)
    fasta = os.path.join(workdir, "aln.fasta")
    _write_fasta(fasta, mat, "s")
    smi = _smi()
    pairs = n * (n - 1) // 2
    for measure in ("raw", "tn93"):
        out = os.path.join(workdir, f"main_{measure}.tsv")
        wall, _ = _run_cli(f"main {measure}", [
            fasta, "-m", measure, "--backend", "xla", "-o", out,
        ])
        print(f"[main] {measure} {n} x {WIDTH}: wall {wall:.2f} s,"
              f" {pairs / wall / 1e6:.2f} M pairs/s end to end ({smi})")
        _square_check(f"main {measure}", out, mat, measure, seed=11)
        os.remove(out)
    return {}


def phase_modes(workdir):
    smi = _smi()
    mat = _alignment(N_MODES, seed=5)

    # stream: 2,000 loaded vs 10,000 streamed, k80; rows are emitted
    # loaded-major per streamed record
    loaded, streamed = mat[:N_LOADED], mat[N_LOADED:]
    fl = os.path.join(workdir, "loaded.fasta")
    fs = os.path.join(workdir, "stream.fasta")
    _write_fasta(fl, loaded, "s")
    _write_fasta(fs, streamed, "t")
    out = os.path.join(workdir, "stream.tsv")
    wall, _ = _run_cli("stream", [
        "-i", fl, "-s", fs, "-m", "k80", "--backend", "xla", "-o", out,
    ])
    n1, n2 = loaded.shape[0], streamed.shape[0]
    print(f"[stream] k80 {n1} loaded x {n2} streamed: wall {wall:.2f} s,"
          f" {n1 * n2 / wall / 1e6:.2f} M pairs/s ({smi})")
    spot_check(
        "stream", out, n1 * n2,
        lambda rng: (int(rng.integers(n1)), int(rng.integers(n2))),
        lambda i, j: 1 + j * n1 + i, loaded, streamed,
        lambda i, j: (f"s{i}", f"t{j}"), "k80", seed=12,
    )
    os.remove(out)

    # two-file rectangle: 4,096 x 4,096, tn93
    nr = N_RECT
    a, b = mat[:nr], mat[nr:2 * nr]
    fa = os.path.join(workdir, "a.fasta")
    fb = os.path.join(workdir, "b.fasta")
    _write_fasta(fa, a, "s")
    _write_fasta(fb, b, "t")
    out = os.path.join(workdir, "rect.tsv")
    wall, _ = _run_cli("rect", [
        fa, fb, "-m", "tn93", "--backend", "xla", "-o", out,
    ])
    print(f"[rect] tn93 {nr} x {nr}: wall {wall:.2f} s,"
          f" {nr * nr / wall / 1e6:.2f} M pairs/s ({smi})")
    spot_check(
        "rect", out, nr * nr,
        lambda rng: (int(rng.integers(nr)), int(rng.integers(nr))),
        lambda i, j: 1 + i * nr + j, a, b,
        lambda i, j: (f"s{i}", f"t{j}"), "tn93", seed=13,
    )
    os.remove(out)

    # out-of-core square: n_high on 12,000 x 29,904 with a budget below
    # the padded code matrix alone, so the blocked sweep runs
    fm = os.path.join(workdir, "ooc.fasta")
    _write_fasta(fm, mat, "s")
    out = os.path.join(workdir, "ooc.tsv")
    budget = OOC_BUDGET
    wall, err = _run_cli("ooc", [
        fm, "-m", "n_high", "--backend", "xla", "-o", out,
    ], DISTANCE_TPU_HBM_BUDGET=str(budget))
    if "out-of-core sweep" not in err:
        raise SystemExit("ooc: the blocked out-of-core sweep did not run")
    n = mat.shape[0]
    print(f"[ooc] n_high {n} x {WIDTH}, HBM budget {budget / 1e9:.2f} GB"
          f" (blocked sweep): wall {wall:.2f} s,"
          f" {n * (n - 1) // 2 / wall / 1e6:.2f} M pairs/s ({smi})")
    _square_check("ooc", out, mat, "n_high", seed=14)
    os.remove(out)
    return {}


# -- phase 6: byte parity, in one process ----------------------------------

def _fixture(rng, n, width, amb_frac):
    """Random alignment around a shared ancestor, rich in ambiguity
    codes (the generator of tests/conftest.py::random_seqs)."""
    amb = "RMWSKYVHDBN-?"
    ancestor = rng.choice(list("ACGT"), size=width)
    recs = []
    for i in range(n):
        s = ancestor.copy()
        nmut = rng.integers(0, max(1, width // 4))
        for p in rng.choice(width, size=min(nmut, width), replace=False):
            if rng.random() < amb_frac:
                s[p] = rng.choice(list(amb))
            else:
                s[p] = rng.choice(list("ACGTacgt"))
        recs.append(f">s{i}\n{''.join(s)}\n")
    return "".join(recs).encode()


def phase_parity(workdir):
    """All six measures, square / rectangle / stream, through the CLI's
    entry point in this one process: xla output must equal numpy output
    byte for byte."""
    import jax
    import numpy as np

    from distance_tpu.cli import main as distance

    require_gpu(jax.devices())
    rng = np.random.default_rng(12345)
    fa = os.path.join(workdir, "par_a.fasta")
    fb = os.path.join(workdir, "par_b.fasta")
    na, nb, width = PARITY_SHAPE
    with open(fa, "wb") as f:
        f.write(_fixture(rng, na, width, amb_frac=0.3))
    with open(fb, "wb") as f:
        f.write(_fixture(rng, nb, width, amb_frac=0.3))
    modes = {
        "square": [fa],
        "rectangle": [fa, fb],
        "stream": ["-i", fa, "-s", fb],
    }
    failed = []
    for measure in MEASURES:
        for mode, inputs in modes.items():
            outs = {}
            for backend in ("xla", "numpy"):
                out = os.path.join(workdir, f"par_{backend}.tsv")
                rc = distance(inputs + ["-m", measure, "--backend",
                                        backend, "-o", out])
                if rc != 0:
                    raise SystemExit(f"parity {measure} {mode} {backend}"
                                     f" exited {rc}")
                with open(out, "rb") as f:
                    outs[backend] = f.read()
                os.remove(out)
            same = outs["xla"] == outs["numpy"]
            print(f"[parity] {measure} {mode}: {len(outs['xla'])} bytes,"
                  f" xla == numpy: {same}")
            if not same:
                failed.append(f"{measure}/{mode}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[parity] device peak_bytes_in_use {peak}")
    if failed:
        raise SystemExit(f"parity failures: {failed}")
    return {}


# -- four cards: the GSPMD dp sweep against one card -----------------------

def phase_sweep4(workdir):
    """One raw square sweep at 8,192 x 29,904 on every visible card,
    through the CLI entry point.  Run once with four cards and once with
    CUDA_VISIBLE_DEVICES=0; the parent compares the TSVs."""
    import jax

    import distance_tpu.engine as engine
    from distance_tpu.cli import main as distance

    dev = _device_report()
    n = N_MAIN
    fasta = os.path.join(workdir, "sweep4.fasta")
    if not os.path.exists(fasta):
        _write_fasta(fasta, _alignment(n, seed=0), "s")
    out = os.path.join(workdir, f"sweep4_{dev['count']}.tsv")
    t0 = time.perf_counter()
    rc = distance([fasta, "-m", "raw", "--backend", "xla", "-o", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"sweep on {dev['count']} cards exited {rc}")
    tile = engine._auto_tile(n, "xla")
    mesh = engine._device_mesh(tile)
    print(f"[sweep4] raw {n} x {WIDTH} on {dev['count']} card(s), tile"
          f" {tile}, dp mesh: {mesh.shape if mesh is not None else None}:"
          f" wall {wall:.2f} s ({_smi().splitlines()[0]})")
    if dev["count"] > 1 and mesh is None:
        raise SystemExit("the multi-card sweep did not engage the dp mesh")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()]
    print(f"[sweep4] peak_bytes_in_use per card: {peaks}")
    if dev["count"] > 1 and min(peaks) < 1 << 30:
        raise SystemExit("a card held under 1 GB: the sweep was not sharded")
    return {"device": dev, "tsv": out, "wall_s": wall}


if __name__ == "__main__":
    sys.exit(main())
