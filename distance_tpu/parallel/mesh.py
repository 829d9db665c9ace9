"""Device-mesh sharding for the pairwise counter sweep.

Device-mesh replacement for the reference's thread pool + MPMC channels
(/root/reference/src/lib.rs:269-365, SURVEY.md section 2 parallelism
table):

* **Pair-data parallelism** ("dp"): the target-side rows (the j axis of
  the pair-tile grid) are sharded across chips; every chip sweeps its row
  shard against the (replicated) query strip.  Static, perfectly balanced
  — every tile costs the same, so the reference's dynamic work-stealing
  queue degenerates to a static partition.
* **Site parallelism** ("sp"): the L (sites) axis is sharded; every
  per-pair counter is additive over sites, so a ``psum`` over the site
  axis reconstructs exact totals.  This is the sequence-parallel analog,
  with one small (G, m, n) collective per block.

Results are deterministic regardless of mesh shape: counters are exact
integers, and emission order is fixed by the host-side sweep.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from distance_tpu.ops.features import get_plan


def make_mesh(n_devices: Optional[int] = None, sp: int = 1):
    """A (dp, sp) mesh over the first ``n_devices`` devices."""
    import jax

    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % sp != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by sp {sp}")
    dp = n_devices // sp
    mesh_devices = np.array(devices[:n_devices]).reshape(dp, sp)
    return jax.sharding.Mesh(mesh_devices, ("dp", "sp"))


def sharded_counters_fn(measure: str, mesh):
    """Build a jitted sharded counter function over ``mesh``.

    Signature: (x_strip (m, L) uint8 replicated, y_rows (n, L) uint8
    sharded (dp, sp)) -> (G, m, n) int32 replicated.

    The x side is replicated (it is one strip of rows — small); the y side
    is row-sharded over "dp" and site-sharded over "sp".  Per-device
    partial counters over the site shard are exact integers; a psum over
    "sp" restores totals, and the row-sharded output is left sharded over
    "dp" for the host gather to assemble in canonical order.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distance_tpu.ops.pairwise_xla import counters_xla as kern

    plan = get_plan(measure)

    def local(x, y):
        part = kern(x, y, plan)
        return jax.lax.psum(part, "sp")

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, "sp"), P("dp", "sp")),
        out_specs=P(None, None, "dp"),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_step(measure: str, mesh):
    """One full sharded 'step': counters + in-graph f32 distance estimate.

    Used by the multi-chip dry run: demonstrates the complete device-side
    pipeline (feature build, int8 contraction, psum over site shards,
    cross-shard output layout) in a single jitted program.  The exact f64
    finalization stays on host (parity requires glibc libm) — this
    in-graph float path exists for the dry-run's end-to-end compile
    check.
    """
    import jax
    import jax.numpy as jnp

    counters = sharded_counters_fn(measure, mesh)
    plan = get_plan(measure)
    idx = {name: k for k, name in enumerate(plan.counters)}

    def step(x, y):
        c = counters(x, y).astype(jnp.float32)
        if measure in ("n", "n_high"):
            return c[idx["diff"]]
        if measure in ("raw", "jc69"):
            p = c[idx["diff"]] / (c[idx["same"]] + c[idx["diff"]])
            if measure == "raw":
                return p
            return -0.75 * jnp.log(1.0 - (4.0 / 3.0) * p)
        if measure == "k80":
            count_l = c[idx["same"]] + c[idx["ts"]] + c[idx["tv"]]
            p = c[idx["ts"]] / count_l
            q = c[idx["tv"]] / count_l
            return -0.5 * jnp.log((1.0 - 2.0 * p - q) * jnp.sqrt(1.0 - 2.0 * q))
        # tn93's in-graph estimate needs base counts; return count_d rate.
        return (c[idx["kk"]] - c[idx["same"]]) / c[idx["kk"]]

    return jax.jit(step)
