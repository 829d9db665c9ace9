"""Tests that need an NVIDIA GPU (marker ``gpu``).

The default suite forces the CPU backend, so these skip there; the
``gpu`` fixture decides inside the test session, never at import.  Run
them on a machine with a card:

    DISTANCE_TPU_TEST_DEVICE=1 XLA_PYTHON_CLIENT_PREALLOCATE=false \
        python -m pytest tests/test_gpu_device.py -q -m gpu

Without preallocation off, the test process reserves 75 % of the card
and the CLI subprocess of test_cli_production_defaults_match_numpy gets
only the rest.
"""

import os

import numpy as np
import pytest

from distance_tpu.measures import MEASURES

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(
            "needs a GPU: run with DISTANCE_TPU_TEST_DEVICE=1 on a machine"
            " with a card"
        )
    return jax.devices()[0]


@pytest.fixture(scope="module")
def device_data():
    from distance_tpu.encoding import ALL_CODES

    rng = np.random.default_rng(0)
    x = rng.choice(ALL_CODES, size=(128, 1024)).astype(np.uint8)
    y = rng.choice(ALL_CODES, size=(256, 1024)).astype(np.uint8)
    return x, y


@pytest.mark.parametrize("measure", MEASURES)
def test_xla_counters_exact_on_device(measure, device_data, gpu):
    import jax.numpy as jnp

    from distance_tpu.engine import _counters_numpy
    from distance_tpu.ops.features import get_plan
    from distance_tpu.ops.pairwise_xla import counters_xla

    x, y = device_data
    plan = get_plan(measure)
    got = np.asarray(counters_xla(jnp.asarray(x), jnp.asarray(y), plan))
    assert np.array_equal(got, _counters_numpy(x, y, plan))


def test_engine_device_backend_matches_numpy(tmp_path, gpu):
    from tests.conftest import make_fasta, random_seqs
    from tests.test_golden import expected_square, run_engine

    rng = np.random.default_rng(3)
    fasta = make_fasta(random_seqs(rng, 40, 200, amb_frac=0.25))
    got, _ = run_engine("tn93", fasta, backend="xla", tile_i=8, tile_j=16)
    assert got == expected_square("tn93", fasta)


@pytest.mark.parametrize("measure", ["jc69", "tn93"])
def test_cli_production_defaults_match_numpy(tmp_path, measure, gpu):
    """Full product path on the real device at DEFAULT tile/pack
    settings: `python -m distance_tpu.cli` subprocess (device backend)
    byte-compared against the numpy-backend CLI on a bench-shaped
    low-diversity alignment (shared ancestor + point mutations + N/gap
    sprinkle), exercising the rel-pack ladder and the ordered writer
    end to end."""
    import subprocess
    import sys

    from distance_tpu.encoding import A, C, G, T, N, GAP

    rng = np.random.default_rng(11)
    n, width = 256, 4096
    bases = np.array([A, C, G, T], dtype=np.uint8)
    mat = np.tile(rng.choice(bases, size=width), (n, 1))
    rows = np.repeat(np.arange(n), 20)
    mat[rows, rng.integers(0, width, size=n * 20)] = rng.choice(
        bases, size=n * 20
    )
    amb = rng.integers(0, n * width, size=n * width // 200)
    mat.reshape(-1)[amb] = np.where(
        rng.random(amb.size) < 0.8, N, GAP
    ).astype(np.uint8)
    inv = {A: "A", G: "G", C: "C", T: "T", N: "N", GAP: "-"}
    fp = tmp_path / "aln.fasta"
    with open(fp, "w") as f:
        for i, row in enumerate(mat):
            f.write(f">s{i}\n" + "".join(inv[b] for b in row) + "\n")

    def run_cli(backend, out):
        # this test process already holds the card: the CLI allocates
        # on demand from what is left
        subprocess.run(
            [sys.executable, "-m", "distance_tpu.cli", str(fp),
             "-m", measure, "--backend", backend, "-o", str(out)],
            check=True, timeout=1200,
            env=dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false"),
        )

    dev_out = tmp_path / "dev.tsv"
    np_out = tmp_path / "np.tsv"
    run_cli("xla", dev_out)
    run_cli("numpy", np_out)
    assert dev_out.read_bytes() == np_out.read_bytes()
