"""distance_tpu — a pairwise genetic-distance engine on JAX accelerators.

A from-scratch reimplementation of the capabilities of the reference Rust CLI
``distance`` (benjamincjackson/distance) built on JAX/XLA:

* Sequences are packed with the Paradis 8-bit nucleotide encoding into a
  ``(n_seqs, L)`` uint8 matrix resident in device memory.
* Every distance measure is decomposed into per-pair *integer counters* that
  are bilinear forms over small per-site feature channels, so the O(n^2 * L)
  pairwise site sweep runs as a batched int8 GEMM (exact {-1,0,1} features,
  int32 accumulation => exact integers).
* The closed-form measure transforms (jc69/k80/tn93) are finalized in f64 on
  the host, replaying the reference's exact expression shapes for bit-for-bit
  TSV parity (reference: /root/reference/src/measures.rs).
* Multi-chip scaling shards the pair-tile grid over a ``jax.sharding.Mesh``;
  the sequence matrix is replicated or row-sharded and results are merged in
  canonical (row-major) order.

Public API mirrors the reference's layer map (see SURVEY.md section 1).
"""

from distance_tpu.encoding import ENCODING, encoding_array
from distance_tpu.fastaio import (
    Alignment,
    DistanceError,
    consensus,
    load_fasta,
    load_fastas,
)
from distance_tpu.engine import Setup, run, set_up

__version__ = "0.1.0"

__all__ = [
    "ENCODING",
    "encoding_array",
    "Alignment",
    "DistanceError",
    "consensus",
    "load_fasta",
    "load_fastas",
    "Setup",
    "run",
    "set_up",
    "__version__",
]
