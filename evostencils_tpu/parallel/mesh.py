"""Device-mesh execution: spatially sharded grids + batched evaluation.

The JAX replacement for the reference's two external parallel layers
(SURVEY.md §2.3): ExaStencils' MPI domain decomposition with
`communicate` halo exchanges, and OpenMP threading inside a rank.

Design: fields are sharded over a `jax.sharding.Mesh` with axes
  * "dp" — data parallel over independent problem instances (the analog of
    evaluation samples / PDE-parameter ladders, vmapped),
  * "sp" — spatial sharding of the leading grid axis.
Stencil applications are written as pad+shift sums (ops/stencil_ops.py),
so under jit with sharded operands XLA's SPMD partitioner inserts the
halo exchanges (collective-permutes, which XLA hands to NCCL)
automatically — no hand-written MPI analog is needed, and the same code
runs unmodified on one device or several.  The GPUs of one host are
joined all to all, so the mesh shape follows the algorithm alone.

Coarse grids, created inside a step by restriction, fall below the
partitioner's profitability threshold and are resharded or replicated
automatically: multigrid coarse levels are latency-bound.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def build_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None):
    """Create a (dp, sp) mesh over the available devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"a mesh of {n} devices needs {n}; JAX found {len(devices)}")
    # jax.devices() lists each device once: every shard gets its own.
    devices = np.asarray(devices[:n])
    if dp is None:
        # favor spatial sharding; dp absorbs what sp cannot
        sp = 1
        for candidate in range(int(np.sqrt(n)), 0, -1):
            if n % candidate == 0:
                sp = n // candidate
                break
        dp = n // sp
    else:
        if n % dp != 0:
            raise ValueError(
                f"dp={dp} does not divide the device count {n}; "
                f"pick dp in {[d for d in range(1, n + 1) if n % d == 0]}"
            )
        sp = n // dp
    return Mesh(devices.reshape(dp, sp), axis_names=("dp", "sp"))


def shard_state(state, mesh: Mesh, batched: bool = False):
    """Apply (dp-batch, sp-rows) sharding constraints to a state tuple."""
    specs = []
    for x in state:
        if batched:
            spec = P("dp", "sp", *([None] * (x.ndim - 2)))
        else:
            spec = P("sp", *([None] * (x.ndim - 1)))
        specs.append(NamedSharding(mesh, spec))
    return tuple(
        jax.lax.with_sharding_constraint(x, s) for x, s in zip(state, specs)
    )


def batched_sharded_evaluation(
    step: Callable,
    mesh: Mesh,
    residual_fn: Callable,
    n_iterations: int,
) -> Callable:
    """Build the multi-chip "training step": a dp-batch of problem instances,
    each spatially sharded over sp, advanced n_iterations cycles.

    Returns a jitted fn (u_batch, f_batch) -> (u_batch, residual_norms).
    This is the shape the driver's dryrun_multichip exercises.
    """

    def one_instance(u, f):
        def body(_, carry):
            return step(carry, f)

        u = jax.lax.fori_loop(0, n_iterations, body, u)
        return u, residual_fn(u, f)

    vmapped = jax.vmap(one_instance)

    @jax.jit
    def run(u_batch, f_batch):
        u_batch = shard_state(u_batch, mesh, batched=True)
        f_batch = shard_state(f_batch, mesh, batched=True)
        u_out, res = vmapped(u_batch, f_batch)
        u_out = shard_state(u_out, mesh, batched=True)
        return u_out, res

    return run
