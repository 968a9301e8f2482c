#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, checked against references.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded-mesh path only

One process drives the card(s); every phase prints PASS or FAIL with its
numbers, and any failure exits non-zero.

  device     JAX must see GPUs (otherwise this raises); the card's name and
             power limit come from nvidia-smi, and the card must be in the
             peaks table (evostencils_tpu/utils/peaks.py).
  numerics   each operation whose GPU implementation was chosen by
             measurement, at real widths on random data, against a plain
             float64 numpy reference (evostencils_tpu/ops/reference.py):
             the red-black collective-Jacobi step the lowering emits
             (5- and 9-point, 1023²), restriction and prolongation
             1023²↔511², the dense coarsest-grid solve of poisson_2d(5, 9)
             (31², 961 unknowns) and the block-Jacobi local solves for
             periods (2, 2) and (8, 1).  Gate: max error ≤ 1e-5 of max|ref|,
             which float32 with Precision.HIGHEST meets and a TF32 product
             (~1e-3) does not.
  end to end (a) textbook V(2,1), poisson_2d(6, 10) f32 (1023²): ρ and
             iterations against the same power iteration in float64 on the
             host CPU backend; (b) the stored champion on poisson_2d(5, 9);
             (c) evolution through scripts/optimize.py (NSGA-II, μ=λ=8,
             2 generations); (d) Helmholtz k=80 complex128 with outer
             BiCGStab against the CPU complex128 run; (e) a textbook FAS
             V(2,2) on fas_2d(5, 9) (per-structure compile path).
  findings   timings and the 1023² V(2,1) solve's memory analysis
             (printed, not gated).

With --four-gpus: a 1023² V(2,2) through JaxProgramGenerator on a
(dp=1, sp=4) mesh against the same evaluation on one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evostencils_tpu.backend.evaluation import JaxProgramGenerator  # noqa: E402
from evostencils_tpu.backend.lowering import CycleLowering  # noqa: E402
from evostencils_tpu.grammar import gp  # noqa: E402
from evostencils_tpu.grammar import multigrid as mg  # noqa: E402
from evostencils_tpu.ir import base  # noqa: E402
from evostencils_tpu.ir.reference_cycles import generate_v_cycle  # noqa: E402
from evostencils_tpu.ops import coarse_solve, intergrid, smoothers  # noqa: E402
from evostencils_tpu.ops import reference as ref  # noqa: E402
from evostencils_tpu.problems.fas import fas_2d  # noqa: E402
from evostencils_tpu.problems.helmholtz import helmholtz_2d  # noqa: E402
from evostencils_tpu.problems.poisson import poisson_2d  # noqa: E402
from evostencils_tpu.stencils import constant, gallery, periodic  # noqa: E402
from evostencils_tpu.utils import REPO_ROOT, enable_persistent_compile_cache  # noqa: E402
from evostencils_tpu.utils.peaks import peaks_for  # noqa: E402
from evostencils_tpu.utils.profiling import evaluation_report  # noqa: E402
from evostencils_tpu.utils.timing import per_cycle_time  # noqa: E402

TOLERANCE = 1e-5  # of max|ref|: float32 at Precision.HIGHEST, not TF32
N = 1023


class CompileSeconds:
    """Backend compile seconds spent in this process, from JAX's own
    monitoring events (persistent-cache hits spend none)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._record)

    def _record(self, event, duration, **kwargs):
        if event == self.EVENT:
            self.total += duration


class Phases:
    def __init__(self):
        self.failures = []

    def check(self, name: str, ok: bool, detail: str) -> bool:
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failures.append(name)
        return ok


def card_name_and_power_limit() -> str:
    """`name, power.limit` from nvidia-smi, read in a child process."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def gpu_devices():
    """jax.devices() when they are GPUs; raises otherwise."""
    devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(f"no GPU: JAX found {platforms} devices")
    return devices


def phase_device(phases: Phases, devices):
    print(f"card: {card_name_and_power_limit()}", flush=True)
    kind = devices[0].device_kind
    peaks = peaks_for(kind)  # raises for a card without published peaks
    phases.check(
        "device", True,
        f"platform={devices[0].platform} kind={kind} count={len(devices)} "
        f"peaks={peaks.hbm_bytes_per_s / 1e12:.2f} TB/s, "
        f"{peaks.f32_flops / 1e12:.0f} TFLOP/s f32 ({peaks.source})",
    )


def compare(phases: Phases, name: str, got, want) -> float:
    err = ref.max_relative_error(np.asarray(got), want)
    phases.check(name, err <= TOLERANCE,
                 f"max error {err:.2e} of max|ref| (float32, gate {TOLERANCE:g})")
    return err


def nine_point_laplacian(h: float) -> constant.Stencil:
    scale = 1.0 / (6.0 * h * h)
    return constant.Stencil(
        [((i, j), scale * (20.0 if (i, j) == (0, 0) else
                            -4.0 if abs(i) + abs(j) == 1 else -1.0))
         for i in (-1, 0, 1) for j in (-1, 0, 1)]
    )


def phase_numerics(phases: Phases, findings: dict):
    rng = np.random.default_rng(2026)
    h = 1.0 / (N + 1)
    grid = base.Grid((N + 1, N + 1), (h, h), 10)
    lap5 = gallery.Poisson2D().generate_stencil(grid)

    # Red-black collective-Jacobi step as the lowering emits it.
    for name, stencil in (("5-point", lap5), ("9-point", nine_point_laplacian(h))):
        u = rng.standard_normal((N, N)).astype(np.float32)
        f = (stencil.center_value() * rng.standard_normal((N, N))).astype(np.float32)
        step = CycleLowering(jnp.float32).lower(
            ref.red_black_cycle(stencil, (N, N), 1.15))
        got = jax.jit(lambda a, b: step((a,), (b,))[0])(u, f)
        compare(phases, f"red-black step {name} {N}²", got,
                ref.red_black_step(u, f, 1.15, stencil.entries))
        findings[f"rb_step_{name}_{N}_us"] = 1e6 * per_cycle_time(
            step, (jnp.asarray(u),), (jnp.asarray(f),), iters=200)

    # Restriction and prolongation on the strided-slice path.
    R = gallery.full_weighting_restriction_stencil(2)
    P = gallery.multilinear_interpolation_stencil(2)
    m = (N - 1) // 2
    fine = rng.standard_normal((N, N)).astype(np.float32)
    coarse = rng.standard_normal((m, m)).astype(np.float32)
    restrict = jax.jit(lambda x: intergrid.restrict(x, R, (m, m), (2, 2)))
    prolong = jax.jit(lambda x: intergrid.prolong(x, P, (N, N), (2, 2)))
    compare(phases, f"restrict {N}²→{m}²", restrict(fine),
            ref.restrict(fine, R.entries, (m, m), (2, 2)))
    compare(phases, f"prolong {m}²→{N}²", prolong(coarse),
            ref.prolong(coarse, P.entries, (N, N), (2, 2)))
    findings[f"restrict_prolong_roundtrip_{N}_us"] = 1e6 * per_cycle_time(
        lambda x, y: prolong(restrict(x)) + y,
        jnp.asarray(fine), jnp.asarray(fine), iters=200)

    # Dense coarsest-grid solve of poisson_2d(5, 9): 31², 961 unknowns.
    problem = poisson_2d(min_level=5, max_level=9, dtype=jnp.float32)
    grids5 = problem.grid_at(5)
    A5 = mg.generate_system_operator(problem.equations, problem.operators,
                                     problem.fields, 5, 0, grids5)
    spec = CycleLowering(jnp.float32)._dense_spec(A5)
    shape5 = grids5[0].interior_shape
    matrix = np.real(coarse_solve.assemble_scalar_matrix(
        A5.entries[0][0].generate_stencil(), shape5))
    r = rng.standard_normal(shape5)
    got = jax.jit(lambda x: spec.apply((x,))[0])(r.astype(np.float32))
    compare(phases, f"dense coarse solve {shape5[0]}² ({matrix.shape[0]} unknowns)",
            got, np.linalg.solve(matrix, r.reshape(-1)).reshape(shape5))

    # Block-Jacobi local solves.
    r = rng.standard_normal((N, N))
    for period in ((2, 2), (8, 1)):
        bd = periodic.block_diagonal(lap5, period)
        spec32 = smoothers.build_block_solve_spec([[bd]], [period], (N, N), jnp.float32)
        spec64 = smoothers.build_block_solve_spec([[bd]], [period], (N, N), jnp.float64)
        got = jax.jit(lambda x: spec32.apply((x,))[0])(r.astype(np.float32))
        compare(phases, f"block solve period {period} {N}²", got,
                ref.block_solve([r], spec64.inv_l, period)[0])
        # Rescaled by the diagonal so that repeated application neither
        # underflows nor overflows.
        scale = lap5.center_value()
        findings[f"block_solve_{period[0]}x{period[1]}_{N}_us"] = 1e6 * per_cycle_time(
            lambda x, y: tuple(scale * v for v in spec32.apply(x)),
            (jnp.asarray(r, jnp.float32),), None, iters=200)


def poisson_v_cycle(problem, pre, post, depth):
    _, terminals = mg.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=depth,
        maximum_local_system_size=8,
    )
    return generate_v_cycle(terminals, problem.rhs(), pre, post)


def iterations_to(rho: float, epsilon: float = 1e-12) -> int:
    return int(math.ceil(math.log(epsilon) / math.log(rho)))


def phase_a(phases: Phases, findings: dict, cpu, compiled: CompileSeconds):
    problem = poisson_2d(min_level=6, max_level=10, dtype=jnp.float32)
    cycle = poisson_v_cycle(problem, 2, 1, 4)
    gen = JaxProgramGenerator(problem)
    t0, c0 = time.perf_counter(), compiled.total
    t_ms, rho, its = gen.generate_and_evaluate(cycle, evaluation_samples=3)
    wall, compile_s = time.perf_counter() - t0, compiled.total - c0
    with jax.default_device(cpu):
        problem64 = poisson_2d(min_level=6, max_level=10, dtype=jnp.float64)
        rho64 = JaxProgramGenerator(problem64).power_iteration_rate(
            poisson_v_cycle(problem64, 2, 1, 4))
    its64 = iterations_to(rho64)
    phases.check(
        "(a) V(2,1) poisson_2d(6,10) f32 1023²",
        abs(rho - rho64) <= 0.1 * rho64 and abs(its - its64) <= 1
        and 0.05 <= rho <= 0.12,
        f"GPU f32 ρ={rho:.6f} its={its} time-to-1e-12={t_ms:.3f} ms; "
        f"CPU f64 ρ={rho64:.6f} its={its64}; wall {wall:.1f} s, "
        f"compile {compile_s:.1f} s",
    )
    # Findings: per-cycle device time and the solve's memory analysis.
    u0, f = problem.initial_state(jnp.float32)
    findings["v21_cycle_1023_us"] = 1e6 * per_cycle_time(
        CycleLowering(jnp.float32).lower(cycle), u0, f, iters=40)
    (stage, _, _), omega_arg, _ = gen._build_solver(cycle)
    memory = stage.lower(u0, f, omega_arg).compile().memory_analysis()
    findings["v21_solve_1023_memory"] = {
        k: getattr(memory, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(memory, k)
    }


def phase_b(phases: Phases):
    from evostencils_tpu.utils.champions import apply_stored_omegas, parse_champion_file

    problem = poisson_2d(min_level=5, max_level=9, dtype=jnp.float32)
    pset, _ = mg.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4, maximum_local_system_size=8,
    )
    tree, omegas = parse_champion_file(
        os.path.join(REPO_ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt"))
    expr, _ = gp.compile_tree(gp.parse_tree(tree, pset), pset)
    applied = apply_stored_omegas(expr, omegas, label="smoke champion")
    gen = JaxProgramGenerator(problem)
    t_ms, rho, its = gen.generate_and_evaluate(expr, evaluation_samples=3)
    phases.check("(b) stored champion poisson_2d(5,9) f32 511²",
                 applied and rho < 0.2,
                 f"ρ={rho:.6f} its={its} time-to-1e-12={t_ms:.3f} ms "
                 f"(tuned ω applied: {applied})")


def phase_c(phases: Phases, compiled: CompileSeconds):
    from scripts.optimize import run

    argv = ["--problem", "poisson2d", "--method", "nsga2", "--mu", "8",
            "--lambda", "8", "--generations", "2", "--evaluation-samples", "3",
            "--seed", "7",
            "--output", os.path.join(REPO_ROOT, "results_chip_smoke")]
    t0, c0 = time.perf_counter(), compiled.total
    generator, pops, _ = run(argv)
    wall, compile_s = time.perf_counter() - t0, compiled.total - c0
    report = evaluation_report(generator)
    evaluated = [ind for pop in pops for ind in pop]
    unevaluated = [ind for ind in evaluated if not ind.fitness_values]
    converging = sum(1 for ind in pops[-1] if ind.fitness_values[0] < 1.0)
    phases.check(
        "(c) evolution scripts/optimize.py poisson2d NSGA-II μ=λ=8 × 2",
        not unevaluated and report["device_failures"] == 0,
        f"{len(evaluated)} individuals, {len(unevaluated)} unevaluated, "
        f"{converging}/{len(pops[-1])} converging; VM hit rate "
        f"{report['vm_hit_rate']}, compile {compile_s:.1f} s, "
        f"wall {wall:.1f} s, device failures {report['device_failures']}",
    )


def phase_d(phases: Phases, cpu):
    results = {}
    for label, device in (("GPU", None), ("CPU", cpu)):
        context = (jax.default_device(device) if device is not None
                   else contextlib.nullcontext())
        with context:
            problem = helmholtz_2d(min_level=3, max_level=7, k=80.0,
                                   dtype=jnp.complex128)
            _, terminals = mg.generate_primitive_set(
                problem.approximation(), problem.rhs(), problem.dimension,
                problem.coarsening_factors, problem.max_level,
                problem.equations, problem.operators, problem.fields,
                depth=4, maximum_local_system_size=8,
            )
            cycle = generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=0.6)
            gen = JaxProgramGenerator(problem)
            t0 = time.perf_counter()
            t_ms, rho, its = gen.generate_and_evaluate(cycle, evaluation_samples=1)
            results[label] = (t_ms, rho, its, time.perf_counter() - t0)
    (t_g, rho_g, its_g, wall_g), (_, rho_c, its_c, wall_c) = results["GPU"], results["CPU"]
    phases.check(
        "(d) Helmholtz k=80 complex128 outer BiCGStab to 1e-7",
        its_g < 10000 and abs(its_g - its_c) <= 0.05 * its_c,
        f"GPU outer its={its_g} ρ={rho_g:.6f} time-to-1e-7={t_g:.3f} ms "
        f"(wall {wall_g:.1f} s); CPU complex128 outer its={its_c} "
        f"ρ={rho_c:.6f} (wall {wall_c:.1f} s)",
    )


def phase_e(phases: Phases):
    problem = fas_2d(min_level=5, max_level=9, dtype=jnp.float32)
    pset, terminals = mg.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4,
        maximum_local_system_size=4, FAS=True,
    )
    text = mg.textbook_cycle_string(terminals, 2, 2, omega_index=18, FAS=True,
                                    smoother_name="jacobi_newton")
    expr, _ = gp.compile_tree(gp.parse_tree(text, pset), pset)
    gen = JaxProgramGenerator(problem)
    t0 = time.perf_counter()
    t_ms, rho, its = gen.generate_and_evaluate(expr, evaluation_samples=1)
    stats = gen.vm_stats()
    phases.check(
        "(e) textbook FAS V(2,2) Newton fas_2d(5,9) f32 511²",
        0.0 < rho < 1.0 and t_ms < 1e50 and stats["vm_hits"] == 0,
        f"ρ={rho:.6f} its={its} time-to-1e-12={t_ms:.3f} ms; per-structure "
        f"compile {gen.compile_time_total:.1f} s (VM hits {stats['vm_hits']}), "
        f"wall {time.perf_counter() - t0:.1f} s",
    )


def phase_four_gpus(phases: Phases, devices):
    from evostencils_tpu.parallel.mesh import build_mesh

    if len(devices) < 4:
        raise RuntimeError(f"--four-gpus needs 4 GPUs, JAX found {len(devices)}")
    problem = poisson_2d(min_level=6, max_level=10, dtype=jnp.float32)
    cycle = poisson_v_cycle(problem, 2, 2, 4)
    single = JaxProgramGenerator(problem)
    _, rho1, its1 = single.generate_and_evaluate(cycle, evaluation_samples=3)
    mesh = build_mesh(4, dp=1)
    sharded = JaxProgramGenerator(problem, mesh=mesh)
    t0 = time.perf_counter()
    t4, rho4, its4 = sharded.generate_and_evaluate(cycle, evaluation_samples=3)
    wall = time.perf_counter() - t0
    (stage, _, _), omega_arg, _ = sharded._build_solver(cycle)
    u0, f = problem.initial_state(jnp.float32)
    best_u = jax.block_until_ready(stage(u0, f, omega_arg))[3][0]
    shard_devices = sorted(d.id for d in best_u.sharding.device_set)
    phases.check(
        "four GPUs: 1023² V(2,2) on a (dp=1, sp=4) mesh vs one GPU",
        abs(rho4 - rho1) <= 1e-3 * rho1 and its4 == its1
        and len(set(shard_devices)) == 4,
        f"mesh ρ={rho4:.6f} its={its4} time-to-1e-12={t4:.3f} ms "
        f"(wall {wall:.1f} s); one GPU ρ={rho1:.6f} its={its1}; "
        f"solution shards on devices {shard_devices}",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the sharded 4-GPU mesh path")
    args = parser.parse_args(argv)
    sys.setrecursionlimit(100000)

    devices = gpu_devices()
    enable_persistent_compile_cache()
    compiled = CompileSeconds()
    cpu = jax.devices("cpu")[0]
    phases = Phases()
    phase_device(phases, devices)
    if args.four_gpus:
        phase_four_gpus(phases, devices)
    else:
        findings = {}
        phase_numerics(phases, findings)
        phase_a(phases, findings, cpu, compiled)
        phase_b(phases)
        phase_c(phases, compiled)
        phase_d(phases, cpu)
        phase_e(phases)
        findings["backend_compile_s_total"] = compiled.total
        print("findings: " + json.dumps(findings), flush=True)
    if phases.failures:
        print(f"{len(phases.failures)} phase(s) failed: {phases.failures}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
