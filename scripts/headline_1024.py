#!/usr/bin/env python
"""Headline benchmark: 2D Poisson 1024² time-to-1e-10 residual.

Measures textbook V-cycles and evolved champions with the ENTIRE staged
solve compiled into one XLA executable (backend/device_solve.py), so the
dispatch cost is paid once per solve — the fair analog of the reference's
in-process C++ solve loop (reference code_generation/exastencils.py:417-443).

Reported per solver:
  * measured asymptotic ρ (power iteration, backend/evaluation.py),
  * cycles executed to the 1e-10 relative-residual target,
  * device time-to-target (min/median over repeats, one dispatch each),
  * per-cycle device time (fori-loop differencing: (t(3K)-t(K))/2K),
  * modeled HBM traffic per cycle (models/roofline.estimate_traffic —
    an unfused upper bound on bytes, so the utilization column is an
    upper bound too) against the device's published peak bandwidth
    (utils/peaks.py).

Usage:
  python scripts/headline_1024.py                       # textbook V(2,1)/V(2,2)
  python scripts/headline_1024.py --champion artifacts/poisson2d_champion_run1.txt --tune
"""

import argparse
import sys
import time

from evostencils_tpu.utils.champions import parse_champion_file
from evostencils_tpu.utils.timing import per_cycle_time


def restart_time(apply_a64, u64, f64, iters=20):
    """Per-restart device seconds: the f64 residual r = f − A·u plus the
    f32 cast that re-seeds the next stage.  Same fori-loop differencing
    as per_cycle_time; the 1e-30-scaled feedback keeps every iteration
    live (no CSE/hoist)."""
    import jax
    import jax.numpy as jnp

    def k_loop(n):
        @jax.jit
        def run(u, f):
            def body(i, uu):
                r64 = tuple(ff - aa for ff, aa in zip(f, apply_a64(uu)))
                fs = tuple(x.astype(jnp.float32) for x in r64)
                return tuple(
                    a + 1e-30 * b.astype(jnp.float64) for a, b in zip(uu, fs)
                )

            out = jax.lax.fori_loop(0, n, body, u)
            return sum(jnp.sum(x * x) for x in out)

        jax.block_until_ready(run(u64, f64))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(run(u64, f64))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = k_loop(iters)
    t3 = k_loop(3 * iters)
    return max((t3 - t1) / (2 * iters), 1e-9)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--min-level", type=int, default=6)
    parser.add_argument("--max-level", type=int, default=10)
    parser.add_argument("--target", type=float, default=1e-10)
    parser.add_argument("--repeats", type=int, default=9)
    parser.add_argument("--champion", action="append", default=[],
                        help="artifact file with a champion tree string")
    parser.add_argument("--tune", action="store_true",
                        help="gradient-retune champion ω at this size")
    parser.add_argument("--predicted", action="store_true",
                        help="predicted-cycle stages from measured ρ (no "
                             "per-cycle residual norms or stall hunting): "
                             "cycle counts track 1/log(ρ), so better "
                             "evolved cycles show their device-compute "
                             "advantage")
    args = parser.parse_args()

    sys.setrecursionlimit(100000)
    import jax

    from evostencils_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    # Float64 on device carries the fused solver's restart residuals
    # (the final 1e-10 verification runs in host f64).
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from evostencils_tpu.backend.device_solve import staged_solver_for_expression
    from evostencils_tpu.backend.evaluation import JaxProgramGenerator
    from evostencils_tpu.backend.lowering import CycleLowering
    from evostencils_tpu.grammar import gp
    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.ir.reference_cycles import generate_v_cycle
    from evostencils_tpu.models.roofline import PerformanceEvaluator
    from evostencils_tpu.problems.poisson import poisson_2d

    problem = poisson_2d(
        min_level=args.min_level, max_level=args.max_level, dtype=jnp.float32
    )
    depth = args.max_level - args.min_level
    pset, terminal_list = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=depth,
        maximum_local_system_size=8,
    )
    operator = terminal_list[0].operator

    solvers = []
    for pre, post in ((2, 1), (2, 2)):
        expr = generate_v_cycle(
            terminal_list, problem.rhs(), pre_smoothing=pre, post_smoothing=post
        )
        solvers.append((f"textbook V({pre},{post})", expr, None))
    for path in args.champion:
        tree_string, omegas = parse_champion_file(path)
        tree = gp.parse_tree(tree_string, pset)
        expr, _ = gp.compile_tree(tree, pset)
        name = path.rsplit("/", 1)[-1].replace(".txt", "")
        if omegas is not None and not args.tune:
            # Write the stored tuned ω into the expression so BOTH the ρ
            # measurement and the lowering see them; on a count mismatch
            # the helper warns and keeps the grammar string's own factors
            # (feeding a short vector to the parameterized lowering would
            # silently clamp out-of-bounds ω indices).
            from evostencils_tpu.utils.champions import apply_stored_omegas

            if apply_stored_omegas(expr, omegas, label=path):
                name += " (tuned ω)"
            omegas = None
        if args.tune:
            from evostencils_tpu.optimization.relaxation import (
                tune_relaxation_factors,
            )

            omegas, _ = tune_relaxation_factors(expr, problem, iterations=60)
            omegas = None  # factors are set in place on the expression
            name += " (retuned)"
        solvers.append((name, expr, omegas))

    lowering32 = CycleLowering(jnp.float32)
    lowering64 = CycleLowering(jnp.float64)
    generator = JaxProgramGenerator(problem, dtype=jnp.float32)
    device_kind = jax.devices()[0].device_kind
    perf = PerformanceEvaluator(device_kind=device_kind)

    u0_32, f_32 = problem.initial_state(jnp.float32)

    rows = []
    t_restart = None
    for name, expr, omegas in solvers:
        _, rho, _ = generator.generate_and_evaluate(expr, evaluation_samples=1)

        solve, f64_rhs = staged_solver_for_expression(
            lowering32, expr, operator, problem, generator,
            omegas=omegas, target=args.target, fused=True,
            lowering64=lowering64,
            rho=(float(rho) if args.predicted and rho < 1.0 else None),
            calibrate_floor=(args.predicted and rho < 1.0),
        )
        floor = getattr(solve, "measured_floor", None)
        cycles, rel, stages = solve(f_32, f64_rhs)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            cycles, rel, stages = solve(f_32, f64_rhs)
            times.append(time.perf_counter() - t0)
        times.sort()
        t_min, t_med = times[0], times[len(times) // 2]

        if omegas is not None:
            pstep, _ = lowering32.lower_parameterized(expr)
            om = jnp.asarray(omegas, jnp.float32)
            step = lambda u, f: pstep(u, f, om)  # noqa: E731
        else:
            step = lowering32.lower(expr)
        t_cycle = per_cycle_time(step, u0_32, f_32)
        if t_restart is None:
            # Identical restart body for every solver (A is the problem
            # operator, not the cycle) — measure once.
            u64_probe = tuple(
                jnp.zeros(s, jnp.float64) for s in (x.shape for x in u0_32)
            )
            f64_probe = tuple(jnp.asarray(x, jnp.float64) for x in f64_rhs)
            t_restart = restart_time(
                lambda u: lowering64.system_apply(operator, u),
                u64_probe, f64_probe,
            )
        # Device compute: cycles ride the f32 step; each stage pays one
        # f64 restart residual; +1 for the final target check.
        device_ms = 1e3 * (cycles * t_cycle + (int(stages) + 1) * t_restart)
        bytes_cycle = perf.estimate_traffic(expr)
        bw = bytes_cycle / t_cycle
        rows.append({
            "solver": name,
            "rho": float(rho),
            "cycles": int(cycles),
            "stages": int(stages),
            "rel_residual": float(rel),
            "device_ms": device_ms,
            "t_min_ms": 1e3 * t_min,
            "t_med_ms": 1e3 * t_med,
            "t_cycle_us": 1e6 * t_cycle,
            "t_restart_us": 1e6 * t_restart,
            "measured_floor": floor,
            "GBps": bw / 1e9,
            "bw_util_pct": 100.0 * bw / perf.peak_bandwidth,
        })
        print(f"[{name}] rho={rho:.4f} cycles={int(cycles)} "
              f"stages={int(stages)} rel={float(rel):.2e} "
              f"device={device_ms:.2f}ms wall_min={1e3*t_min:.1f}ms "
              f"t_cycle={1e6*t_cycle:.1f}us t_restart={1e6*t_restart:.1f}us "
              f"floor={floor if floor is None else f'{floor:.1e}'} "
              f"bw={bw/1e9:.0f}GB/s", flush=True)

    n = 2 ** args.max_level
    print(f"\n## 2D Poisson {n}² time-to-{args.target:g} (one-jit staged solve, "
          f"{device_kind})\n")
    print("| solver | ρ | cycles | stages | DEVICE compute ms | "
          "wall (min/med ms) | per-cycle µs | per-restart µs | "
          "modeled GB/s | BW util % |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['solver']} | {r['rho']:.3f} | {r['cycles']} | "
              f"{r['stages']} | **{r['device_ms']:.2f}** | "
              f"{r['t_min_ms']:.1f} / {r['t_med_ms']:.1f} | "
              f"{r['t_cycle_us']:.1f} | {r['t_restart_us']:.1f} | "
              f"{r['GBps']:.0f} | {r['bw_util_pct']:.0f} |")
    print("\nDEVICE compute = cycles × per-cycle + (stages+1) × per-restart "
          "(f64 residual + f32 cast); wall adds dispatch and the host-f64 "
          "verification transfers.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
