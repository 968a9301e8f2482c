#!/usr/bin/env python
"""Main evolutionary-optimization driver (reference scripts/optimize.py).

Runs grammar-guided genetic programming for a chosen problem family
entirely on device, dumps hall-of-fame individuals as re-evaluable
grammar strings plus pickled logbooks/populations.

Examples:
  python scripts/optimize.py --problem poisson2d --method nsga2 \
      --mu 8 --lambda 8 --generations 50
  python scripts/optimize.py --problem poisson2d --model-based \
      --method sogp --generations 20
  python scripts/optimize.py --problem helmholtz --generations 20
"""

import argparse
import os
import random
import sys


def run(argv=None):
    """Parse ``argv`` (default: sys.argv), run the evolution and write the
    results; returns (generator, populations, halls of fame)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--problem", default="poisson2d",
                        choices=["poisson2d", "poisson3d", "poisson2d_var",
                                 "elasticity", "helmholtz", "fas"])
    parser.add_argument("--method", default="nsga2",
                        choices=["nsga2", "nsga3", "sogp", "random"])
    parser.add_argument("--mu", type=int, default=8)
    parser.add_argument("--lambda", dest="lambda_", type=int, default=8)
    parser.add_argument("--generations", type=int, default=50)
    parser.add_argument("--generalization-interval", type=int, default=150)
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--levels-per-run", type=int, default=None)
    parser.add_argument("--evaluation-samples", type=int, default=3)
    parser.add_argument("--crossover-probability", type=float, default=0.7)
    parser.add_argument("--mutation-probability", type=float, default=0.3)
    parser.add_argument("--max-local-system-size", type=int, default=8)
    parser.add_argument("--model-based", action="store_true",
                        help="LFA + roofline fitness instead of on-device runs")
    parser.add_argument("--tune", action="store_true",
                        help="gradient-tune the best individual's relaxation "
                             "factors after evolution")
    parser.add_argument("--problem-file", default=None,
                        help="load a reference .exa2/.exa3/.exa4 spec "
                             "directly instead of a named problem")
    parser.add_argument("--knowledge", default=None,
                        help=".knowledge file for --problem-file (auto-"
                             "discovered next to the spec when omitted)")
    parser.add_argument("--helmholtz-k0", type=float, default=80.0,
                        help="base wavenumber for --problem helmholtz; the "
                             "generalization ramp doubles it per step with "
                             "h·k fixed (k0=20 + --generalization-interval G "
                             "gives the 20→40→80 curriculum that ends at the "
                             "reference's k=80 configuration)")
    parser.add_argument("--seed-file", action="append", default=[],
                        help="file whose first non-comment line is a grammar "
                             "string seeded into the initial population "
                             "(repeatable; e.g. a champion from a smaller-k "
                             "curriculum stage)")
    parser.add_argument("--seed-textbook", action="append", default=[],
                        metavar="PRE,POST,OMEGA[,SMOOTHER]",
                        help="seed a textbook V(PRE,POST) cycle at relaxation "
                             "OMEGA into the initial population (repeatable; "
                             "e.g. 2,1,0.6 for the reference Helmholtz "
                             "default shape).  Optional 4th field picks the "
                             "smoother production (collective_jacobi default; "
                             "jacobi_picard/jacobi_newton for FAS problems)")
    parser.add_argument("--continue-from-checkpoint", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output", default=None, help="result directory")
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument("--dtype", default=None,
                        help="override the problem dtype (e.g. complex128 "
                             "with --cpu to evolve at the reference's "
                             "double precision; 64-bit dtypes enable x64)")
    parser.add_argument("--outer-cap", type=int, default=None,
                        help="override the outer Krylov iteration cap during "
                             "evolution (e.g. 600 at k=80: converging "
                             "preconditioners finish in ~450 its, hopeless "
                             "ones die ~17x sooner than the reference's "
                             "10000 cap; validate champions at the full cap "
                             "with scripts/evaluate_helmholtz_ladder.py)")
    parser.add_argument("--ladder-rungs", type=int, default=3,
                        help="k-ladder rungs per Helmholtz fitness "
                             "(reference: 3 = k,2k,4k). Use 1 during "
                             "evolution to keep selection pressure on the "
                             "base k; validate champions on the full "
                             "ladder with evaluate_helmholtz_ladder.py")
    parser.add_argument("--no-outer", action="store_true",
                        help="strip the problem's outer Krylov driver and "
                             "evolve on the inner (preconditioner) system "
                             "directly — e.g. design the shifted-Laplace "
                             "cycle on M, then evaluate champions inside "
                             "PreconditionedBiCGStab separately")
    parser.add_argument("--mesh", default=None, metavar="DP,SP",
                        help="evaluate on a jax.sharding.Mesh: DP×SP devices "
                             "(data-parallel × spatial rows); e.g. --mesh 1,4 "
                             "on 4 GPUs.  Fine-grid states shard over sp; "
                             "XLA inserts the halo exchanges (rehearse with "
                             "XLA_FLAGS=--xla_force_host_platform_device_"
                             "count=4 JAX_PLATFORMS=cpu)")
    parser.add_argument("--multihost", action="store_true",
                        help="split the population across jax.distributed "
                             "processes (launcher must call "
                             "jax.distributed.initialize; the mpi4py-rank "
                             "analog, reference program.py:285-310)")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from evostencils_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    from evostencils_tpu.backend.evaluation import JaxProgramGenerator
    from evostencils_tpu.models.lfa import ConvergenceEvaluator
    from evostencils_tpu.models.roofline import PerformanceEvaluator
    from evostencils_tpu.optimization.optimizer import Optimizer
    from evostencils_tpu.problems import build_named_problem, load_problem_file
    from evostencils_tpu.utils.profiling import evaluation_report

    if args.problem_file:
        problem = load_problem_file(args.problem_file, args.knowledge)
        problem = problem.with_levels(
            args.min_level if args.min_level is not None else problem.min_level,
            args.max_level if args.max_level is not None else problem.max_level,
        )
    elif args.problem == "helmholtz":
        from evostencils_tpu.problems.helmholtz import (
            helmholtz_2d, max_level_for_k,
        )

        max_level = (
            args.max_level if args.max_level is not None
            else max_level_for_k(args.helmholtz_k0)
        )
        problem = helmholtz_2d(
            min_level=args.min_level if args.min_level is not None else 3,
            max_level=max_level, k=args.helmholtz_k0,
        )
    else:
        problem = build_named_problem(
            args.problem,
            args.min_level if args.min_level is not None else 5,
            args.max_level if args.max_level is not None else 9,
        )
    if args.no_outer and getattr(problem, "outer_solver", None):
        problem = problem._clone(outer_solver=None)
    elif args.outer_cap and getattr(problem, "outer_solver", None):
        problem = problem._clone(
            outer_solver=dict(problem.outer_solver,
                              max_iterations=args.outer_cap)
        )
    if args.dtype:
        import jax.numpy as jnp

        if "64" in args.dtype or "128" in args.dtype:
            jax.config.update("jax_enable_x64", True)
        problem = problem._clone(dtype=getattr(jnp, args.dtype))

    output_dir = args.output or f"results_{problem.name}"
    os.makedirs(output_dir, exist_ok=True)

    mesh = None
    if args.mesh:
        from evostencils_tpu.parallel.mesh import build_mesh

        dp, sp = (int(x) for x in args.mesh.split(","))
        mesh = build_mesh(dp * sp, dp=dp)
        print(f"Evaluating on mesh {mesh}", flush=True)

    generator = JaxProgramGenerator(
        problem, mesh=mesh, ladder_rungs=args.ladder_rungs
    )
    convergence_evaluator = None
    performance_evaluator = None
    if args.model_based:
        convergence_evaluator = ConvergenceEvaluator(
            problem.dimension, problem.coarsening_factors, problem.finest_grid
        )
        performance_evaluator = PerformanceEvaluator(
            device_kind=jax.devices()[0].device_kind
        )

    rng = random.Random(args.seed)
    dispatcher = None
    if args.multihost:
        from evostencils_tpu.parallel.dispatch import MultiHostDispatcher

        dispatcher = MultiHostDispatcher()
    optimizer = Optimizer.for_problem(
        problem,
        dispatcher=dispatcher,
        program_generator=generator,
        convergence_evaluator=convergence_evaluator,
        performance_evaluator=performance_evaluator,
        checkpoint_directory_path=os.path.join(output_dir, "checkpoints"),
        rng=rng,
    )
    method = {
        "nsga2": optimizer.NSGAII,
        "nsga3": optimizer.NSGAIII,
        "sogp": optimizer.SOGP,
    }.get(args.method, optimizer.NSGAII)

    pde_parameter_values = {}
    if args.problem == "helmholtz":
        from evostencils_tpu.problems.helmholtz import helmholtz_ladder

        pde_parameter_values = {
            "k": [k for k, _ in helmholtz_ladder(4, k0=args.helmholtz_k0)]
        }

    seed_individuals = []
    for path in args.seed_file:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith("#"):
                    seed_individuals.append(line)
                    break
    if args.seed_textbook:
        from evostencils_tpu.grammar.multigrid import (
            generate_primitive_set, textbook_cycle_string,
        )

        depth = problem.max_level - problem.min_level
        fas = bool(getattr(problem, "uses_fas", False))
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), problem.dimension,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=depth,
            maximum_local_system_size=args.max_local_system_size,
            FAS=fas,
        )
        from evostencils_tpu.utils.champions import omega_index

        for spec_str in args.seed_textbook:
            parts = spec_str.split(",")
            pre, post, omega = int(parts[0]), int(parts[1]), float(parts[2])
            kwargs = {}
            if len(parts) > 3:
                kwargs["smoother_name"] = parts[3]
            seed_individuals.append(
                textbook_cycle_string(tl, pre, post,
                                      omega_index=omega_index(omega),
                                      FAS=fas, **kwargs)
            )

    best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
        mu_=args.mu,
        lambda_=args.lambda_,
        generations=args.generations,
        generalization_interval=args.generalization_interval,
        crossover_probability=args.crossover_probability,
        mutation_probability=args.mutation_probability,
        optimization_method=method,
        use_random_search=args.method == "random",
        levels_per_run=args.levels_per_run,
        evaluation_samples=args.evaluation_samples,
        continue_from_checkpoint=args.continue_from_checkpoint,
        maximum_local_system_size=args.max_local_system_size,
        model_based_estimation=args.model_based,
        pde_parameter_values=pde_parameter_values,
        seed_individuals=seed_individuals or None,
        verbose=True,
    )

    # Durable artifacts (reference scripts/optimize.py:159-179): grammar
    # strings are the re-evaluable representation.
    for j, individual in enumerate(hofs[-1][: 2 * args.mu]):
        with open(os.path.join(output_dir, f"individual_{j}.txt"), "w") as f:
            f.write(str(individual) + "\n")
            f.write(f"# fitness: {individual.fitness_values}\n")
    with open(os.path.join(output_dir, "program.txt"), "w") as f:
        f.write(program)
    Optimizer.dump_data_structure(
        [lb.records for lb in logbooks], os.path.join(output_dir, "logbooks.p")
    )
    Optimizer.dump_data_structure(
        [[(str(i), i.fitness_values) for i in pop] for pop in pops],
        os.path.join(output_dir, "populations.p"),
    )
    print(f"\nBest individual:\n{best}")

    if args.tune and not args.model_based:
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.optimization.relaxation import tune_relaxation_factors

        expr, _ = gp.compile_tree(gp.parse_tree(best, optimizer._pset), optimizer._pset)
        t0v, rho0, it0 = generator.generate_and_evaluate(expr, evaluation_samples=3)
        tuned, _ = tune_relaxation_factors(expr, generator.problem)
        # No cache clear: the solver cache is keyed with parameterized
        # relaxation and omega values are re-read from the expression on
        # every lookup, so the tuned re-measurement reuses the compiled
        # executable.
        t1v, rho1, it1 = generator.generate_and_evaluate(expr, evaluation_samples=3)
        print(f"Gradient-tuned relaxation factors: rho {rho0:.4f} -> {rho1:.4f}, "
              f"iterations {it0} -> {it1}")
        # The tuner's linear asymptotic probe can DEGRADE nonlinear (FAS)
        # champions (round 5: rho 0.0029 -> 0.93 on the FAS champion).
        # Only publish the tuned artifact when it actually improved; always
        # record both measurements so a regression is visible.
        if rho1 <= rho0:
            with open(os.path.join(output_dir, "individual_0_tuned.txt"), "w") as f:
                f.write(str(gp.parse_tree(best, optimizer._pset)) + "\n")
                f.write(f"# tuned omegas: {[round(w, 4) for w in tuned]}\n")
                f.write(f"# rho: {rho0} -> {rho1}\n")
        else:
            print("Tuned omegas degraded the champion; keeping the untuned "
                  "string (tuner probe assumes a linear cycle operator).")
            with open(os.path.join(output_dir, "individual_0_tune_rejected.txt"),
                      "w") as f:
                f.write(f"# tuning REJECTED: rho {rho0} -> {rho1}\n")
                f.write(f"# rejected omegas: {[round(w, 4) for w in tuned]}\n")

    print(f"Evaluation report: {evaluation_report(generator)}")
    print(f"Results written to {output_dir}/")
    return generator, pops, hofs


def main():
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
