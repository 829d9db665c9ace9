"""Test configuration: force CPU JAX with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh (no card
needed).  Tests marked ``gpu`` need a card; see tests/test_gpu_device.py.
"""

import os

# Hermetic by default: force the CPU backend with 8 virtual devices so the
# sharding tests run anywhere.  Set DISTANCE_TPU_TEST_DEVICE=1 to keep the
# ambient backend (a GPU) for the ``gpu``-marked tests.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("DISTANCE_TPU_TEST_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    # override any platform already configured, before a backend
    # initializes
    import jax

    jax.config.update("jax_platforms", "cpu")

import io
from typing import List, Optional

import numpy as np
import pytest

import distance_tpu.measures as measures
from distance_tpu.writer import format_float


def make_fasta(records) -> bytes:
    out = []
    for rid, seq in records:
        out.append(f">{rid}\n{seq}\n")
    return "".join(out).encode()


def random_seqs(rng, n, width, alphabet="ACGT", amb_frac=0.0):
    """Random alignment around a shared ancestor, optionally rich in
    ambiguity codes."""
    amb = "RMWSKYVHDBN-?"
    ancestor = rng.choice(list(alphabet), size=width)
    seqs = []
    for i in range(n):
        s = ancestor.copy()
        nmut = rng.integers(0, max(1, width // 4))
        pos = rng.choice(width, size=min(nmut, width), replace=False)
        for p in pos:
            if amb_frac and rng.random() < amb_frac:
                s[p] = rng.choice(list(amb))
            else:
                s[p] = rng.choice(list("ACGTacgt"))
        seqs.append("".join(s))
    return [(f"s{i}", seqs[i]) for i in range(n)]


def oracle_pair_value(measure: str, q, t, qc=None, tc=None):
    if measure in ("n", "n_high"):
        return measures.snp(q, t)
    if measure == "raw":
        return measures.raw(q, t)
    if measure == "jc69":
        return measures.jc69(q, t)
    if measure == "k80":
        return measures.k80(q, t)
    if measure == "tn93":
        return measures.tn93(q, t, qc, tc)
    raise ValueError(measure)


def oracle_tsv(measure: str, aln1, aln2=None, stream_ids=None) -> bytes:
    """Serial reference TSV (exact order + formatting).

    aln2=None: within-alignment upper triangle.  Otherwise between
    alignments (rectangle).  ``stream_ids`` switches to stream-mode
    emission order/columns: aln2 is the streamed side.
    """
    rows = ["sequence1\tsequence2\tdistance"]

    def fmt(v):
        if isinstance(v, int):
            return str(v)
        return format_float(v)

    def counts(aln, i):
        return tuple(aln.base_counts[i]) if aln.base_counts is not None else None

    if aln2 is None:
        n = aln1.n
        for i in range(n - 1):
            for j in range(i + 1, n):
                v = oracle_pair_value(
                    measure, aln1.matrix[i], aln1.matrix[j],
                    counts(aln1, i), counts(aln1, j),
                )
                rows.append(f"{aln1.ids[i]}\t{aln1.ids[j]}\t{fmt(v)}")
    elif stream_ids is None:
        for i in range(aln1.n):
            for j in range(aln2.n):
                v = oracle_pair_value(
                    measure, aln1.matrix[i], aln2.matrix[j],
                    counts(aln1, i), counts(aln2, j),
                )
                rows.append(f"{aln1.ids[i]}\t{aln2.ids[j]}\t{fmt(v)}")
    else:
        # stream mode: outer over streamed records, inner over loaded
        for j in range(aln2.n):
            for i in range(aln1.n):
                v = oracle_pair_value(
                    measure, aln1.matrix[i], aln2.matrix[j],
                    counts(aln1, i), counts(aln2, j),
                )
                rows.append(f"{aln1.ids[i]}\t{stream_ids[j]}\t{fmt(v)}")
    return ("\n".join(rows) + "\n").encode()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
