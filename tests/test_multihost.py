"""Multi-host runner: --launch, --num-hosts/--host-id, --coordinator,
stream-mode sharding + .units merge.  Byte-identical to single-host."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from distance_tpu.engine import Setup, run
from distance_tpu.fastaio import consensus as consensus_fn, load_fastas
from distance_tpu.parallel.multihost import UnitIndex, merge_parts
from distance_tpu.writer import TsvWriter
from tests.conftest import make_fasta, random_seqs
from tests.test_golden import expected_square, run_engine


@pytest.fixture(scope="module")
def fastas():
    rng = np.random.default_rng(23)
    f1 = make_fasta(random_seqs(rng, 13, 70, amb_frac=0.2))
    f2 = make_fasta(random_seqs(rng, 41, 70, amb_frac=0.2))
    return f1, f2


def run_stream_shard(measure, f1, f2, shard, out_path, batchsize=3):
    """One sharded stream run writing a part file + .units sidecar."""
    loaded = load_fastas([io.BytesIO(f1)])
    cons = consensus_fn(loaded) if measure == "n" else None
    if measure == "tn93":
        loaded[0].count_bases()
    out = open(out_path, "wb")
    setup = Setup(
        loaded=loaded,
        streamed=io.BytesIO(f2),
        writer=TsvWriter(out),
        measure=measure,
        n_threads=1,
        batchsize=batchsize,
        backend="numpy",
        consensus=cons,
        shard=shard,
        out_path=str(out_path),
    )
    if shard is not None and shard[0] != 0:
        setup.writer.suppress_header()
    run(setup)
    out.close()


@pytest.mark.parametrize("nshards", [2, 3])
@pytest.mark.parametrize("measure", ["n", "raw", "tn93"])
def test_stream_shards_merge(measure, nshards, fastas, tmp_path, monkeypatch):
    # small device groups so several units exist per shard
    monkeypatch.setenv("DISTANCE_TPU_STREAM_GROUP", "4")
    f1, f2 = fastas
    parts = []
    for k in range(nshards):
        p = tmp_path / f"part{k}"
        run_stream_shard(measure, f1, f2, (k, nshards), str(p))
        assert (tmp_path / f"part{k}.units").exists()
        parts.append(str(p))
    merged = tmp_path / "merged.tsv"
    with open(merged, "wb") as out:
        merge_parts(out, parts)
    expect, _ = run_engine(measure, f1, stream=f2, backend="numpy")
    assert merged.read_bytes() == expect
    # merge cleaned up parts + sidecars
    assert not os.path.exists(parts[0])
    assert not os.path.exists(parts[0] + ".units")


def test_stream_shard_without_output_path_skips_units(fastas):
    """Sharded stream into a non-file sink still works (no .units)."""
    f1, f2 = fastas
    loaded = load_fastas([io.BytesIO(f1)])
    out = io.BytesIO()
    setup = Setup(
        loaded=loaded, streamed=io.BytesIO(f2), writer=TsvWriter(out),
        measure="raw", n_threads=1, batchsize=2, backend="numpy",
        shard=(0, 2),
    )
    run(setup)
    assert out.getvalue().startswith(b"sequence1\t")


def write_inputs(tmp_path, fastas):
    f1, f2 = fastas
    a = tmp_path / "a.fasta"
    b = tmp_path / "b.fasta"
    a.write_bytes(f1)
    b.write_bytes(f2)
    return a, b


def cli(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "distance_tpu.cli"] + args,
        capture_output=True, **kw,
    )


def test_launch_square(tmp_path, fastas):
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    r = cli([str(a), "-m", "jc69", "--backend", "numpy", "--launch", "3",
             "-o", str(o)])
    assert r.returncode == 0, r.stderr
    assert o.read_bytes() == expected_square("jc69", f1)
    # no leftover parts
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_launch_stream(tmp_path, fastas):
    f1, f2 = fastas
    a, b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    r = cli(["-i", str(a), "-s", str(b), "-m", "k80", "--backend", "numpy",
             "-b", "2", "--launch", "2", "-o", str(o)])
    assert r.returncode == 0, r.stderr
    expect, _ = run_engine("k80", f1, stream=f2, backend="numpy",
                           batchsize=2)
    assert o.read_bytes() == expect
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_launch_stdout(tmp_path, fastas):
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    r = cli([str(a), "-m", "n", "--backend", "numpy", "--launch", "2"])
    assert r.returncode == 0, r.stderr
    assert r.stdout == expected_square("n", f1)


def test_launch_rejects_stdin(fastas):
    f1, _ = fastas
    r = cli(["--launch", "2", "--backend", "numpy"], input=f1)
    assert r.returncode == 1
    assert b"stdin" in r.stderr


def test_hosts_flags_merge(tmp_path, fastas):
    """Two real processes, explicit --num-hosts/--host-id, shared-FS
    rendezvous: host 0 merges once host 1's marker lands."""
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "distance_tpu.cli", str(a), "-m", "raw",
             "--backend", "numpy", "--num-hosts", "2", "--host-id", str(k),
             "-o", str(o)],
            stderr=subprocess.PIPE,
        )
        for k in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=120) == 0, p.stderr.read()
    assert o.read_bytes() == expected_square("raw", f1)
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_hosts_flags_stream(tmp_path, fastas):
    f1, f2 = fastas
    a, b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "distance_tpu.cli", "-i", str(a), "-s",
             str(b), "-m", "tn93", "--backend", "numpy", "--num-hosts", "2",
             "--host-id", str(k), "-o", str(o)],
            stderr=subprocess.PIPE,
        )
        for k in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=120) == 0, p.stderr.read()
    expect, _ = run_engine("tn93", f1, stream=f2, backend="numpy")
    assert o.read_bytes() == expect


def test_coordinator_rendezvous(tmp_path, fastas):
    """jax.distributed startup: indices come from the runtime."""
    import socket

    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "distance_tpu.cli", str(a), "-m", "n",
             "--backend", "numpy", "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", "2", "--host-id", str(k), "-o", str(o)],
            stderr=subprocess.PIPE, env=env,
        )
        for k in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=180) == 0, p.stderr.read()
    assert o.read_bytes() == expected_square("n", f1)


def test_merge_cli_load_mode(tmp_path, fastas):
    """Manual workflow: --shard runs + --merge reproduce the file."""
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    parts = []
    for k in range(2):
        p = tmp_path / f"p{k}.tsv"
        r = cli([str(a), "-m", "k80", "--backend", "numpy",
                 "--shard", f"{k}/2", "-o", str(p)])
        assert r.returncode == 0, r.stderr
        parts.append(str(p))
    o = tmp_path / "out.tsv"
    r = cli(["--merge"] + parts + ["-o", str(o)])
    assert r.returncode == 0, r.stderr
    assert o.read_bytes() == expected_square("k80", f1)
    # --merge without cleanup keeps the parts
    assert os.path.exists(parts[0])


def test_multihost_conflicts(tmp_path, fastas):
    a, _b = write_inputs(tmp_path, fastas)
    r = cli([str(a), "--num-hosts", "2", "--host-id", "0", "--shard",
             "0/2", "--backend", "numpy", "-o", str(tmp_path / "o")])
    assert r.returncode == 1
    assert b"--shard conflicts" in r.stderr
    r = cli([str(a), "--num-hosts", "2", "--backend", "numpy",
             "-o", str(tmp_path / "o")])
    assert r.returncode == 1
    assert b"--num-hosts and --host-id" in r.stderr


def test_worker_failure_reported(tmp_path, fastas):
    """A failing shard worker fails the launch (no silent partial file)."""
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    r = cli([str(a), "--backend", "numpy", "--launch", "2",
             "-o", str(tmp_path / "o.tsv")])
    assert r.returncode == 1
    assert b"worker shard" in r.stderr


def test_unit_index_roundtrip(tmp_path):
    ix = UnitIndex(str(tmp_path / "p"))
    ix.preamble = 29
    ix.append(0, 100)
    ix.append(2, 50)
    ix.save()
    ix2 = UnitIndex(str(tmp_path / "p"))
    assert ix2.load()
    assert ix2.preamble == 29 and ix2.units == [[0, 100], [2, 50]]
    ix2.truncate(1)
    assert ix2.units == [[0, 100]]
    ix2.clear()
    assert not os.path.exists(ix.sidecar)


def test_launch_xla_virtual_mesh(tmp_path, fastas):
    """--launch workers running the xla backend over a virtual device
    mesh: process fan-out and GSPMD sharding compose byte-identically."""
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    r = subprocess.run(
        [sys.executable, "-m", "distance_tpu.cli", str(a), "-m", "jc69",
         "--backend", "xla", "--launch", "2", "-o", str(o)],
        capture_output=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert o.read_bytes() == expected_square("jc69", f1)


def test_worker_failure_removes_partial_output(tmp_path):
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    o = tmp_path / "o.tsv"
    r = cli([str(a), "--backend", "numpy", "--launch", "2", "-o", str(o)])
    assert r.returncode == 1
    assert not o.exists()


def test_worker_failure_removes_parts_and_sidecars(tmp_path):
    """--launch failure must not leave partK/.units leftovers: a later
    run at the same -o would misread a fresh load-mode part through a
    stale stream-mode unit index (round-5 review finding)."""
    a = tmp_path / "bad.fasta"
    a.write_bytes(b">x\nACGT\n>y\nACG!\n")
    o = tmp_path / "o.tsv"
    # plant a stale sidecar from a hypothetical earlier stream run
    (tmp_path / "o.tsv.part0.units").write_text('{"preamble": 99}')
    r = cli([str(a), "--backend", "numpy", "--launch", "2", "-o", str(o)])
    assert r.returncode == 1
    assert not o.exists()
    assert not list(tmp_path.glob("o.tsv.part*"))


def test_stale_done_marker_is_ignored(tmp_path, fastas):
    """A .done marker from an earlier run (different fingerprint) at the
    same -o path must not gate or corrupt the merge: host 0 waits for a
    CURRENT marker instead of merging a stale/mid-write part."""
    f1, _ = fastas
    a, _b = write_inputs(tmp_path, fastas)
    o = tmp_path / "out.tsv"
    # stale markers in the OLD (no-fingerprint) and wrong-fp formats
    (tmp_path / "out.tsv.part0.done").write_text("ok")
    (tmp_path / "out.tsv.part1.done").write_text("deadbeef\nok")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "distance_tpu.cli", str(a), "-m", "raw",
             "--backend", "numpy", "--num-hosts", "2", "--host-id", str(k),
             "-o", str(o)],
            stderr=subprocess.PIPE,
        )
        for k in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=120) == 0, p.stderr.read()
    assert o.read_bytes() == expected_square("raw", f1)
    assert not list(tmp_path.glob("out.tsv.part*"))


def test_unexpected_worker_exception_writes_failure_marker(
    tmp_path, fastas, monkeypatch
):
    """ANY host failure (not just DistanceError/OSError) must publish
    the failure marker, or host 0 waits for it forever."""
    import distance_tpu.cli as cli_mod
    from distance_tpu.parallel.multihost import resolve_multihost

    a, _b = write_inputs(tmp_path, fastas)

    class Args:
        pass

    args = Args()
    args.input = None
    args.input_pos_1 = str(a)
    args.input_pos_2 = None
    args.stream = None
    args.measure = "raw"
    args.output = str(tmp_path / "o.tsv")
    args.num_hosts = 2
    args.host_id = 1
    args.coordinator = None
    args.shard = None
    ctx = resolve_multihost(args)
    assert ctx is not None
    from distance_tpu.parallel.multihost import finish_multihost

    finish_multihost(ctx, ok=False, err="RuntimeError boom")
    marker = tmp_path / "o.tsv.part1.done"
    content = marker.read_text().split("\n")
    assert content[0] == ctx.fp
    assert content[1].startswith("err RuntimeError boom")


def _launch_args(a, o, n, backend):
    from distance_tpu.cli import build_parser

    return build_parser().parse_args(
        [str(a), "-m", "raw", "--backend", backend, "--launch", str(n),
         "-o", str(o)]
    )


class _FakeWorker:
    """Stands in for a worker process: writes an empty part file and
    exits 0, recording the environment it was given."""

    envs = []

    def __init__(self, argv, env=None):
        self.envs.append(env)
        with open(argv[argv.index("-o") + 1], "wb"):
            pass

    def poll(self):
        return 0


def test_launch_gives_each_worker_its_own_card(tmp_path, fastas,
                                               monkeypatch):
    import distance_tpu.parallel.multihost as mh

    a, _b = write_inputs(tmp_path, fastas)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setattr(mh, "visible_gpus", lambda: ["0", "1", "2"])
    monkeypatch.setattr(mh.subprocess, "Popen", _FakeWorker)
    _FakeWorker.envs = []
    assert mh.launch(_launch_args(a, tmp_path / "o.tsv", 3, "xla")) == 0
    assert [e["CUDA_VISIBLE_DEVICES"] for e in _FakeWorker.envs] == [
        "0", "1", "2"
    ]


@pytest.mark.parametrize("backend,platforms,refused", [
    ("xla", "cuda", True),
    ("auto", "", True),
    ("numpy", "cuda", False),
    ("xla", "cpu", False),
])
def test_launch_refuses_more_workers_than_cards(
    tmp_path, fastas, monkeypatch, backend, platforms, refused
):
    """N > visible cards is refused for a device run before any worker
    starts (and without the parent opening a card); runs that use no
    card keep no such limit."""
    import distance_tpu.parallel.multihost as mh
    from distance_tpu.fastaio import DistanceError

    a, _b = write_inputs(tmp_path, fastas)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setattr(mh, "visible_gpus", lambda: ["0"])
    monkeypatch.setattr(mh.subprocess, "Popen", _FakeWorker)
    _FakeWorker.envs = []
    args = _launch_args(a, tmp_path / "o.tsv", 2, backend)
    if refused:
        with pytest.raises(DistanceError, match="one accelerator per worker"):
            mh.launch(args)
        assert _FakeWorker.envs == []
    else:
        assert mh.launch(args) == 0
        assert _FakeWorker.envs == [None, None]


def test_visible_gpus_follows_cuda_visible_devices(monkeypatch):
    import distance_tpu.parallel.multihost as mh

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert mh.visible_gpus() == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert mh.visible_gpus() == []
