"""CLI smoke tests: version, licences, usage errors."""

import subprocess
import sys


def run_cli(args, input_data=b""):
    return subprocess.run(
        [sys.executable, "-m", "distance_tpu.cli"] + args,
        input=input_data, capture_output=True,
    )


def test_version():
    r = run_cli(["-V"])
    assert r.returncode == 0
    assert b"distance" in r.stdout


def test_licenses():
    r = run_cli(["-l"])
    assert r.returncode == 0
    assert b"Paradis" in r.stdout


def test_help_lists_flags():
    r = run_cli(["-h"])
    assert r.returncode == 0
    for flag in (b"--input", b"--stream", b"--measure", b"--output",
                 b"--threads", b"--batchsize", b"--licenses"):
        assert flag in r.stdout, flag


def test_negative_batchsize_rejected():
    r = run_cli(["-b", "-3"], input_data=b">a\nACGT\n")
    assert r.returncode == 2


def test_negative_threads_rejected():
    r = run_cli(["-t", "-1"], input_data=b">a\nACGT\n")
    assert r.returncode == 2


def test_threads_zero_clamps():
    r = run_cli(["-t", "0", "-m", "n", "--backend", "numpy"],
                input_data=b">a\nACGT\n>b\nACGA\n")
    assert r.returncode == 0
    assert b"a\tb\t1" in r.stdout


def test_default_threads_and_pool_from_cpu_count(tmp_path, monkeypatch):
    """Omitting -t sizes the host pool from the machine's CPU count
    (/root/reference/src/lib.rs:262 semantics)."""
    import os

    import distance_tpu.engine as engine
    from distance_tpu.cli import build_parser

    monkeypatch.setattr(engine, "_fetch_pool", None)
    fp = tmp_path / "a.fasta"
    fp.write_bytes(b">a\nACGT\n>b\nACGT\n")
    args = build_parser().parse_args([str(fp), "-m", "n"])
    setup = engine.set_up(args)
    ncpu = os.cpu_count() or 1
    assert setup.n_threads == ncpu
    pool = engine._get_fetch_pool()
    # transfer threads are IO-blocked: the default pool oversubscribes
    # the machine's cores; an explicit -t is an exact override
    assert pool._max_workers == min(32, 4 * ncpu)


def test_input_flag_three_files_is_positional_conflict(tmp_path):
    """clap's num_args(0..=2) consumes two values for -i and the third
    falls to a positional, so the reference emits the flag/positional
    conflict (/root/reference/src/lib.rs:85-98,182-184)."""
    f = tmp_path / "a.fasta"
    f.write_bytes(b">a\nACGT\n>b\nACGA\n")
    p = str(f)
    r = run_cli(["-i", p, p, p])
    assert r.returncode == 1
    assert (
        b"For loading input files, don't use both positional arguments"
        b" and the -i/--input flag" in r.stderr
    )
    # five values: two for -i, two positionals, the fifth is a clap
    # usage error (exit 2)
    r = run_cli(["-i", p, p, p, p, p])
    assert r.returncode == 2
    assert b"unexpected argument" in r.stderr


def test_missing_input_file_prints_ioerror_debug():
    """A nonexistent input must print the reference's Debug-rendered
    IOError line (io::Error via #[from], src/lib.rs:22-24; main prints
    `Error: <Debug>` and exits 1) — not a Python traceback."""
    r = run_cli(["definitely_not_here.fasta"])
    assert r.returncode == 1
    assert r.stderr.strip() == (
        b'Error: IOError(Os { code: 2, kind: NotFound,'
        b' message: "No such file or directory" })'
    )
    assert b"Traceback" not in r.stderr
    # streamed-side path too
    r = run_cli(["-s", "also_missing.fasta"])
    assert r.returncode == 1
    # (-s without a loaded file errors first; with one, the open fails)


def test_missing_stream_file_ioerror(tmp_path):
    f = tmp_path / "a.fasta"
    f.write_bytes(b">a\nACGT\n>b\nACGA\n")
    r = run_cli(["-i", str(f), "-s", str(tmp_path / "nope.fasta")])
    assert r.returncode == 1
    assert b"Error: IOError(Os { code: 2, kind: NotFound" in r.stderr
    assert b"Traceback" not in r.stderr


def test_licenses_broken_pipe_exits_zero():
    """`distance -l | head -c1`-style closed stdout must exit 0
    silently, like every other output path."""
    p = subprocess.Popen(
        [sys.executable, "-m", "distance_tpu.cli", "-l"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    p.stdout.read(8)
    p.stdout.close()
    p.wait(timeout=60)
    assert p.returncode == 0
    assert b"Traceback" not in p.stderr.read()


def test_backend_pallas_rejected():
    """The Pallas backend is gone: argparse refuses the value (usage
    error, exit 2) and names the choices that remain."""
    r = run_cli(["--backend", "pallas"], input_data=b">a\nACGT\n")
    assert r.returncode == 2
    assert b"invalid choice: 'pallas'" in r.stderr
    assert b"auto, numpy, xla)" in r.stderr
    h = run_cli(["-h"])
    assert b"pallas" not in h.stdout
