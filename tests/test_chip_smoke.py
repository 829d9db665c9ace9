"""chip_smoke.py's guards and checkers, on the CPU: it must refuse to
report a result without a GPU or outside a checkout, and its HLO and
TSV checkers must see what they claim to see."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_devices():
    import jax

    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def _assert_no_result(r):
    assert r.returncode != 0
    for line in r.stdout.decode().splitlines():
        assert '"ok"' not in line


def test_smoke_fails_without_gpu():
    """Its children ask JAX for cuda; with no card the first phase
    fails and the script prints no result."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, timeout=300, cwd=REPO,
    )
    _assert_no_result(r)
    assert b"phase device failed" in r.stderr


def test_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, timeout=120, cwd=tmp_path,
    )
    _assert_no_result(r)


_HLO = """\
HloModule jit_f

%fused_gemm (p0: s8[2,64], p1: s8[32,64]) -> s32[2,32] {
  %p0 = s8[2,64]{1,0} parameter(0)
  %p1 = s8[32,64]{1,0} parameter(1)
  ROOT %dot.1 = s32[2,32]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={1}
}

%fused_loop (p0: s8[4,64]) -> s32[4,4] {
  %p0 = s8[4,64]{1,0} parameter(0)
  %t = s8[64,4]{0,1} transpose(%p0), dimensions={1,0}
  ROOT %dot.2 = s32[4,4]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}, rhs_contracting_dims={1}
}

ENTRY %main (a: s8[2,64], b: s8[32,64], c: s8[4,64]) -> s32[2,32] {
  %a = s8[2,64]{1,0} parameter(0)
  %b = s8[32,64]{1,0} parameter(1)
  %c = s8[4,64]{1,0} parameter(2)
  %fusion = s32[2,32]{1,0} fusion(%a, %b), kind=kCustom, calls=%fused_gemm, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  %fusion.2 = s32[4,4]{1,0} fusion(%c), kind=kLoop, calls=%fused_loop
  %custom-call.3 = (s32[2,32]{1,0}, s8[0]{0}) custom-call(%a, %b), custom_call_target="__cublas$lt$matmul"
  ROOT %copy.4 = s8[32,64]{0,1} copy(%b)
}
"""


def test_gemm_implementations_names_each_route():
    got = chip_smoke.gemm_implementations(_HLO)
    assert len(got) == 3
    assert any("__triton_gemm" in g and "fused_gemm" in g for g in got)
    assert any("kLoop" in g and "fused_loop" in g for g in got)
    assert any(g.startswith("cuBLAS custom call __cublas$lt$matmul")
               for g in got)


def test_big_copies_reports_layout_changes_by_size():
    # the transpose holds 64*4 = 256 bytes, the copy 32*64 = 2048
    assert len(chip_smoke.big_copies(_HLO, 256)) == 2
    got = chip_smoke.big_copies(_HLO, 257)
    assert len(got) == 1
    assert "%copy.4" in got[0] and "s8[32,64]" in got[0]
    assert chip_smoke.big_copies(_HLO, 2049) == []


@pytest.fixture
def square_tsv(tmp_path, monkeypatch):
    """A numpy-backend TSV of a small alignment written the smoke's way."""
    from distance_tpu.cli import main as distance

    monkeypatch.setattr(chip_smoke, "WIDTH", 50)
    monkeypatch.setattr(chip_smoke, "SPOT_ROWS", 40)
    mat = chip_smoke._alignment(30, seed=4)
    fasta = tmp_path / "a.fasta"
    chip_smoke._write_fasta(str(fasta), mat, "s")
    out = tmp_path / "out.tsv"
    assert distance([str(fasta), "-m", "tn93", "--backend", "numpy",
                     "-o", str(out)]) == 0
    return out, mat


def test_spot_check_passes_a_correct_tsv(square_tsv, capsys):
    out, mat = square_tsv
    chip_smoke._square_check("t", str(out), mat, "tn93", seed=1)
    assert "0 mismatches" in capsys.readouterr().out


def test_spot_check_catches_a_wrong_value(square_tsv):
    out, mat = square_tsv
    lines = out.read_bytes().split(b"\n")
    # corrupt every data row's value: any sampled row must mismatch
    bad = [lines[0]] + [
        l.rsplit(b"\t", 1)[0] + b"\t0.5" for l in lines[1:-1]
    ] + [b""]
    out.write_bytes(b"\n".join(bad))
    with pytest.raises(SystemExit, match="spot-check mismatches"):
        chip_smoke._square_check("t", str(out), mat, "tn93", seed=1)


def test_spot_check_catches_a_missing_row(square_tsv):
    out, mat = square_tsv
    data = out.read_bytes()
    out.write_bytes(data[: data.rstrip(b"\n").rfind(b"\n") + 1])
    with pytest.raises(SystemExit, match="lines, expected"):
        chip_smoke._square_check("t", str(out), mat, "tn93", seed=1)

