"""Pairwise-counter GEMMs in plain JAX, compiled by XLA.

Computes the per-pair integer counters for a block of sequence pairs as a
set of GEMMs over the bilinear feature channels defined in features.py,
on any backend.  On a GPU, XLA hands the int8 contractions to cuBLAS or
to its Triton GEMM emitter (chip_smoke.py phase 2 prints which).

Exactness: features are in {-1, 0, 1} int8 and the contraction uses
preferred_element_type=int32, so every counter is exact integer
arithmetic with no width bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from distance_tpu.ops.features import CounterPlan, features_device, get_plan


def counters_xla(
    x_codes: jnp.ndarray,
    y_codes: jnp.ndarray,
    plan: CounterPlan,
    dtype=jnp.int8,
) -> jnp.ndarray:
    """Counters for every (x, y) pair.

    Feature channels are built with elementwise bit ops (no gathers) and
    contracted as int8 GEMMs, one per counter group.

    Args:
      x_codes: (m, L) uint8 encoded sequences (query side).
      y_codes: (n, L) uint8 encoded sequences (target side).
      plan: CounterPlan for the measure.

    Returns:
      (n_counters, m, n) int32 — exact integer counters.
    """
    prefer = jnp.int32 if dtype == jnp.int8 else jnp.float32
    if prefer == jnp.float32:
        # Float accumulation is exact only while every partial sum stays
        # below 2^24 (products are in {-1, 0, 1}).  Shared-channel (mix)
        # plans cast each SINGLE-channel GEMM to int32 before the
        # integer mix (contract_features), so their bound is 1 x L;
        # per-counter plans fold a group's channels into one GEMM, so
        # theirs is max_group_channels x L.  int8/int32 has no bound.
        per_gemm = 1 if plan.mix_num is not None else plan.max_group_channels
        if per_gemm * x_codes.shape[1] >= 1 << 24:
            raise ValueError(
                "float accumulation would lose integer exactness for "
                f"width {x_codes.shape[1]} x {per_gemm}"
                " channels; use the default int8 dtype"
            )
    fx = features_device(x_codes, plan, "f", jnp, dtype)  # (R, m, L)
    gy = features_device(y_codes, plan, "g", jnp, dtype)  # (R, n, L)
    return contract_features(fx, gy, plan, prefer)


def contract_features(fx, gy, plan: CounterPlan, prefer=jnp.int32):
    """Counter GEMMs over prebuilt (R, m, L) / (R, n, L) feature tensors.

    Split out of counters_xla so the engine can cache feature tensors in
    device memory (built once per matrix / once per strip) instead of
    rematerializing them inside every block dispatch.
    """
    if plan.mix_num is not None:
        # Shared-channel plan: one batched GEMM over sites gives the
        # per-channel pair sums O (R, m, n); counters are exact integer
        # mixes (numerators are even per site, so // is exact — also
        # per site-shard under "sp" psum).
        o = jax.lax.dot_general(
            fx,
            gy,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=prefer,
        ).astype(jnp.int32)
        num = jnp.asarray(plan.mix_num)  # (G, R)
        den = jnp.asarray(plan.mix_den)[:, None, None]
        c = jnp.tensordot(num, o, axes=([1], [0]))
        return c // den
    outs = []
    for name in plan.counters:
        lo, hi = plan.slice_of(name)
        # contraction over (channel, site): one GEMM per counter.
        c = jax.lax.dot_general(
            fx[lo:hi],
            gy[lo:hi],
            dimension_numbers=(((0, 2), (0, 2)), ((), ())),
            preferred_element_type=prefer,
        )
        outs.append(c)
    return jnp.stack(outs).astype(jnp.int32)


def base_counts_device(codes: jnp.ndarray) -> jnp.ndarray:
    """Per-sequence (A, T, G, C) encoded-code tallies on device —
    the tn93 precompute (/root/reference/src/fastaio.rs:53-66) as a
    one-shot device reduction.  (m, L) uint8 -> (m, 4) int32."""
    from distance_tpu.encoding import A, C, G, T

    outs = [
        jnp.sum((codes == v).astype(jnp.int32), axis=1) for v in (A, T, G, C)
    ]
    return jnp.stack(outs, axis=1)
