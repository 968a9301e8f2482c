"""Staged deep solves with device-fused inner loops: time-to-1e-10.

The reference's generated C++ binaries run their solve loop in-process
(reference code_generation/exastencils.py:417-443).  The analog here:
each *stage* — dozens of f32 multigrid cycles plus per-cycle residual
norms and stall detection — compiles into ONE XLA executable driven by
`lax.while_loop`, so a full solve pays the dispatch and host
synchronisation once per stage (3-5 stages), not once per cycle.

Why stages at all: with A-entries of size 4/h² (≈4·2²⁰ at 1024²), the
f32 residual r = f − A·u floors near 5e-3·‖f‖ from term cancellation.  So
the restart residual is computed in float64 (the error equation A·e = r),
and stage reductions compound: s stages reach ~(stage floor)^s, far below
1e-10.  Same math as the evaluation harness's restarted measurement
(backend/evaluation.py), with the inner loop fully fused on device.

Each inner stage stops on any of: stage-target hit, stall (no residual
improvement across a cycle — the f32 floor), iteration cap, divergence.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.ops.stencil_ops import l2_norm as _l2


def _host_l2(state) -> float:
    return float(np.sqrt(sum(np.sum(np.abs(np.asarray(x)) ** 2) for x in state)))


def _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio,
                stage_reduction=None):
    """The shared f32 inner-stage recurrence: smooth the error equation
    A·e = r from zero until the stage target (when `stage_reduction` is
    given), the iteration cap, divergence, or a stall (per-cycle
    improvement worse than `stall_ratio`).  Returns run(fs, rs0) ->
    (e, k, rn, prev_rn) — the single source of truth for the stopping
    semantics used by both staged solvers and the floor probe."""

    def run(fs, rs0):
        e0 = tuple(jnp.zeros(s, jnp.float32) for s in shapes)

        def cond(c):
            _, k, rn, prev = c
            improving = jnp.logical_or(k < 2, rn < stall_ratio * prev)
            keep = jnp.logical_and(
                k < inner_cap, jnp.logical_and(jnp.isfinite(rn), improving)
            )
            if stage_reduction is not None:
                keep = jnp.logical_and(keep, rn > stage_reduction * rs0)
            return keep

        def body(c):
            e, k, rn, _ = c
            e = step(e, fs)
            new_rn = _l2(tuple(f - a for f, a in zip(fs, apply_a32(e))))
            return e, k + 1, new_rn, rn

        return jax.lax.while_loop(
            cond, body, (e0, jnp.int32(0), rs0, jnp.float32(np.inf))
        )

    return run


def build_staged_solver(
    step: Callable,
    apply_a32: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    target: float = 1e-10,
    stage_reduction: float = 1e-5,
    inner_cap: int = 100,
    max_stages: int = 10,
    stall_ratio: float = 0.9,
):
    """Returns solve(f32_rhs_dev, f64_rhs_np) -> (cycles, rel_res, stages).

    `step(u, f) -> u` is one lowered f32 cycle on field tuples;
    `apply_a32` applies the finest operator in f32 (per-cycle residual
    norms, matching the reference solvers' per-iteration residual
    prints); `host_residual(u64_np_tuple) -> r64_np_tuple` computes
    f − A·u in true host f64."""

    run = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio,
                      stage_reduction)

    @jax.jit
    def stage(fs):
        rs0 = _l2(fs)
        e, k, rn, _ = run(fs, rs0)
        return e, k, rn / rs0

    def solve(f32_rhs, f64_rhs_np):
        r64 = tuple(np.asarray(x, np.float64) for x in f64_rhs_np)
        u64 = tuple(np.zeros(s, np.float64) for s in shapes)
        r0 = _host_l2(r64)
        cycles = 0
        stages = 0
        rel = 1.0
        while rel > target and stages < max_stages and cycles < 1000:
            fs = tuple(jnp.asarray(x.astype(np.float32)) for x in r64)
            e, k, _ = jax.block_until_ready(stage(fs))
            kk = int(k)
            if kk == 0:
                break
            u64 = tuple(u + np.asarray(x, np.float64) for u, x in zip(u64, e))
            r64 = host_residual(u64)
            cycles += kk
            stages += 1
            new_rel = _host_l2(r64) / r0
            if new_rel >= rel:
                break  # restart no longer improves — true floor reached
            rel = new_rel
        return cycles, rel, stages

    return solve, stage


def build_fused_staged_solver(
    step: Callable,
    apply_a32: Callable,
    apply_a64: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    target: float = 1e-10,
    stage_reduction: float = 1e-5,
    inner_cap: int = 60,
    max_stages: int = 8,
    stall_ratio: float = 0.9,
):
    """Fully-fused staged solve: ALL stages in ONE executable.

    Restart residuals are computed on device in float64.  The outer loop
    stops on target, stage cap, cycle cap, or no inter-stage progress.
    The host wrapper then verifies against the host float64 residual and,
    if the device stages stopped short of the target, polishes with
    host-restart stages.

    Requires jax_enable_x64 (f64 types must exist on device).

    Returns solve(f32_rhs, f64_rhs_np) -> (cycles, rel_true, stages)."""

    _run_stage = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio,
                             stage_reduction)

    @jax.jit
    def device_solve(f32_rhs, f64_rhs):
        r0 = _l2(f64_rhs)

        def inner(fs):
            rs0 = _l2(fs)
            e, k, _, _ = _run_stage(fs, rs0)
            return e, k

        def outer_cond(c):
            _, r64, cycles, stages, prev_rel = c
            rel = _l2(r64) / r0
            return jnp.logical_and(
                jnp.logical_and(rel > target, rel < prev_rel),
                jnp.logical_and(stages < max_stages, cycles < 500),
            )

        def outer_body(c):
            u64, r64, cycles, stages, _ = c
            rel = _l2(r64) / r0
            fs = tuple(x.astype(jnp.float32) for x in r64)
            e, k = inner(fs)
            u64 = tuple(u + x.astype(jnp.float64) for u, x in zip(u64, e))
            r64 = tuple(f - a for f, a in zip(f64_rhs, apply_a64(u64)))
            return u64, r64, cycles + k, stages + 1, rel

        u0 = tuple(jnp.zeros(s, jnp.float64) for s in shapes)
        u64, r64, cycles, stages, _ = jax.lax.while_loop(
            outer_cond, outer_body,
            (u0, tuple(f64_rhs), jnp.int32(0), jnp.int32(0),
             jnp.float64(np.inf)),
        )
        return u64, cycles, stages

    polish_stage = None

    def solve(f32_rhs, f64_rhs_np):
        nonlocal polish_stage
        f64_dev = tuple(jnp.asarray(x, jnp.float64) for x in f64_rhs_np)
        u64, cycles, stages = jax.block_until_ready(
            device_solve(f32_rhs, f64_dev)
        )
        cycles = int(cycles)
        stages = int(stages)
        u_host = tuple(np.asarray(x, np.float64) for x in u64)
        r_true = host_residual(u_host)
        r0 = _host_l2(tuple(np.asarray(x, np.float64) for x in f64_rhs_np))
        rel = _host_l2(r_true) / r0
        # Host-restart polish: the device stages' floor
        # can stop just short of a 1e-10 target.
        while rel > target and stages < max_stages and cycles < 1000:
            if polish_stage is None:
                _, polish_stage = build_staged_solver(
                    step, apply_a32, host_residual, shapes,
                    target=target, stage_reduction=stage_reduction,
                    inner_cap=inner_cap, stall_ratio=stall_ratio,
                )
            fs = tuple(jnp.asarray(np.asarray(x, np.float32)) for x in r_true)
            e, k, _ = jax.block_until_ready(polish_stage(fs))
            kk = int(k)
            if kk == 0:
                break
            u_host = tuple(u + np.asarray(x, np.float64) for u, x in zip(u_host, e))
            r_true = host_residual(u_host)
            cycles += kk
            stages += 1
            new_rel = _host_l2(r_true) / r0
            if new_rel >= rel:
                break
            rel = new_rel
        return cycles, rel, stages

    return solve


def build_floor_probe(
    step: Callable,
    apply_a32: Callable,
    shapes: Tuple[tuple, ...],
    inner_cap: int = 60,
    stall_ratio: float = 0.95,
):
    """One f32 stage run to stall: probe(fs) -> (k, floor_rel).

    The f32 stage floor is operator- AND cycle-dependent (it scales with
    the rounding noise the cycle injects at the 1/h² operator scale), so
    the conservative 5e-3 default can cost a whole extra restart — each
    restart pays a transient cycle plus a float64 residual.  The
    probe measures the achieved stage reduction at stall (<5 %/cycle
    improvement) so the predicted staged solver can size stages to the
    REAL floor."""

    run = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio)

    @jax.jit
    def probe(fs):
        rs0 = _l2(fs)
        _, k, rn, prev = run(fs, rs0)
        return k, jnp.minimum(rn, prev) / rs0

    return probe


def build_predicted_staged_solver(
    step: Callable,
    apply_a32: Callable,
    apply_a64: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    rho: float,
    target: float = 1e-10,
    floor_estimate: float = 5e-3,
    inner_cap: int = 40,
    max_stages: int = 12,
):
    """Predicted-cycle staged solve: each stage runs EXACTLY
    ceil(log(floor)/log(ρ)) cycles — no per-cycle residual norms, no stall
    hunting — then restarts from the float64 device residual; the
    host verifies (and if needed polishes) against true IEEE f64.

    Rationale: the f32 stage floor (~5e-3 relative at the 1/h² operator
    scale) caps every stage's reduction, and reactive stall detection
    burns ~2 extra cycles per stage on every solver — which flattened the
    round-2 headline cycle counts to ~18-22 regardless of ρ.  With the
    measured asymptotic ρ (the power iteration the evaluation harness
    already runs), the optimal stage length is known a priori; cycles to
    target then scale with 1/log(ρ) and a better evolved cycle actually
    SHOWS its advantage in device compute.  The reference's in-process
    C++ loop pays one residual print per iteration (exastencils.py:417-
    443); here the verification work rides the stage boundary instead.
    """
    rho = float(min(max(rho, 1e-6), 0.95))
    # Initial stage length: one extra cycle absorbs the per-restart
    # transient (a restarted error equation starts from a rough state, so
    # the first cycle contracts ~0.5, not ρ — measured at 1024²).
    k_stage = int(np.clip(np.ceil(np.log(floor_estimate) / np.log(rho)) + 1,
                          2, inner_cap))

    @jax.jit
    def device_solve(f64_rhs, k0):
        r0 = _l2(f64_rhs)
        log_floor = jnp.float64(np.log(floor_estimate))

        def inner(fs, k):
            e0 = tuple(jnp.zeros(s, jnp.float32) for s in shapes)
            return jax.lax.fori_loop(0, k, lambda i, e: step(e, fs), e0)

        def outer_cond(c):
            _, r64, cycles, stages, prev_rel, _ = c
            rel = _l2(r64) / r0
            return jnp.logical_and(
                jnp.logical_and(rel > target, rel < prev_rel),
                jnp.logical_and(stages < max_stages, cycles < 500),
            )

        def outer_body(c):
            u64, r64, cycles, stages, _, k = c
            rel = _l2(r64) / r0
            fs = tuple(x.astype(jnp.float32) for x in r64)
            e = inner(fs, k)
            u64 = tuple(u + x.astype(jnp.float64) for u, x in zip(u64, e))
            r64 = tuple(f - a for f, a in zip(f64_rhs, apply_a64(u64)))
            # Self-tuning stage length: size the next stage from THIS
            # stage's measured effective rate (asymptotic ρ misses the
            # restart transient; the floor caps useful depth).
            new_rel = _l2(r64) / r0
            achieved = jnp.clip(new_rel / rel, 1e-12, 0.97)
            r_eff = jnp.log(achieved) / k.astype(jnp.float64)  # log rate
            # Never run a stage past the REMAINING decades to target: a
            # deep measured floor would otherwise overshoot the final
            # stage (wasted cycles past 1e-10).
            k_remaining = jnp.ceil(
                jnp.log(jnp.clip(target / new_rel, 1e-300, 1.0)) / r_eff
            )
            k_next = (
                jnp.minimum(jnp.ceil(log_floor / r_eff), k_remaining)
                .astype(jnp.int32) + 1
            )
            k_next = jnp.clip(k_next, 2, inner_cap)
            return u64, r64, cycles + k, stages + 1, rel, k_next

        u0 = tuple(jnp.zeros(s, jnp.float64) for s in shapes)
        u64, r64, cycles, stages, _, _ = jax.lax.while_loop(
            outer_cond, outer_body,
            (u0, tuple(f64_rhs), jnp.int32(0), jnp.int32(0),
             jnp.float64(np.inf), k0),
        )
        return u64, cycles, stages

    @jax.jit
    def polish_stage(fs, k):
        e0 = tuple(jnp.zeros(s, jnp.float32) for s in shapes)
        return jax.lax.fori_loop(0, k, lambda i, e: step(e, fs), e0)

    def solve(f32_rhs, f64_rhs_np):
        f64_dev = tuple(jnp.asarray(x, jnp.float64) for x in f64_rhs_np)
        u64, cycles, stages = jax.block_until_ready(
            device_solve(f64_dev, jnp.int32(k_stage))
        )
        cycles = int(cycles)
        stages = int(stages)
        u_host = tuple(np.asarray(x, np.float64) for x in u64)
        r_true = host_residual(u_host)
        r0 = _host_l2(tuple(np.asarray(x, np.float64) for x in f64_rhs_np))
        rel = _host_l2(r_true) / r0
        # Host-restart polish past the device stages' floor.
        while rel > target and stages < max_stages + 4 and cycles < 1000:
            fs = tuple(jnp.asarray(np.asarray(x, np.float32)) for x in r_true)
            e = jax.block_until_ready(polish_stage(fs, jnp.int32(k_stage)))
            u_host = tuple(
                u + np.asarray(x, np.float64) for u, x in zip(u_host, e)
            )
            r_true = host_residual(u_host)
            cycles += k_stage
            stages += 1
            new_rel = _host_l2(r_true) / r0
            if new_rel >= rel:
                break
            rel = new_rel
        return cycles, rel, stages

    return solve


def staged_solver_for_expression(
    lowering32,
    expression,
    operator,
    problem,
    generator,
    level=None,
    omegas=None,
    fused=False,
    lowering64=None,
    rho=None,
    calibrate_floor=False,
    **kwargs,
):
    """Wire `build_staged_solver` from a lowered cycle expression.

    `operator` is the finest-level system operator (from the grammar
    terminals); `omegas` optionally overrides relaxation factors via the
    ω-parameterized lowering (for gradient-tuned champions); `generator`
    (a JaxProgramGenerator) provides the exact host-f64 residual
    (backend/evaluation.py:_host_residual, which handles constant,
    periodic and variable-coefficient entries)."""
    if omegas is not None:
        pstep, _ = lowering32.lower_parameterized(expression)
        om = jnp.asarray(omegas, dtype=jnp.float32)

        def step(u, f):
            return pstep(u, f, om)
    else:
        step = lowering32.lower(expression)

    def apply_a32(u):
        return lowering32.system_apply(operator, u)

    u0, f0 = problem.initial_state(jnp.float32, level=level)
    shapes = tuple(x.shape for x in u0)
    f64_rhs = tuple(np.asarray(x, np.float64) for x in f0)

    def host_residual(u64):
        return tuple(generator._host_residual(operator, u64, f64_rhs))

    if rho is not None:
        # Predicted-cycle stages from the measured asymptotic ρ.
        def apply_a64(u):
            return (lowering64 or lowering32).system_apply(operator, u)

        measured_floor = None
        if calibrate_floor:
            probe = build_floor_probe(step, apply_a32, shapes)
            fs0 = tuple(jnp.asarray(np.asarray(x, np.float32)) for x in f64_rhs)
            _, floor = jax.block_until_ready(probe(fs0))
            measured_floor = float(floor)
            # 2× margin: stage targets sit just above the stall point,
            # where the marginal cycles still contract near ρ.
            kwargs["floor_estimate"] = min(2.0 * measured_floor, 5e-3)

        solve = build_predicted_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, rho=rho,
            **kwargs,
        )
        solve.measured_floor = measured_floor
        return solve, f64_rhs

    if fused:
        def apply_a64(u):
            return (lowering64 or lowering32).system_apply(operator, u)

        solve = build_fused_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, **kwargs
        )
        return solve, f64_rhs

    solve, stage = build_staged_solver(
        step, apply_a32, host_residual, shapes, **kwargs
    )
    return solve, f64_rhs
