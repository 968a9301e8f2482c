"""Optimizer integration: multi-run splitting, generalization ramp,
Krylov coarse solvers, dispatchers."""

import math
import random

import jax.numpy as jnp
import pytest

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, krylov
from evostencils_tpu.ir.reference_cycles import generate_v_22_cycle_two_grid
from evostencils_tpu.optimization.optimizer import Optimizer
from evostencils_tpu.problems.poisson import poisson_2d


def make_optimizer(problem, seed=0, ckpt="/tmp/ck_opt_tests"):
    gen = JaxProgramGenerator(problem, dtype=jnp.float64)
    return Optimizer.for_problem(
        problem, program_generator=gen, checkpoint_directory_path=ckpt,
        rng=random.Random(seed),
    )


class TestMultiRun:
    def test_levels_per_run_chains_coarse_solvers(self, tmp_path):
        problem = poisson_2d(min_level=3, max_level=7, dtype=jnp.float64)
        opt = make_optimizer(problem, seed=9, ckpt=str(tmp_path))
        best, program, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=2, generations=1,
            generalization_interval=100, optimization_method=opt.SOGP,
            evaluation_samples=1, maximum_local_system_size=4,
            levels_per_run=2, verbose=False,
        )
        assert len(hofs) == 2  # coarsest-first, then finest
        assert "# level range [3, 5]" in program
        assert "# level range [5, 7]" in program
        # The finest run must have produced finite-fitness individuals
        # (its coarse-grid solver is the previous run's evolved cycle).
        assert hofs[-1][0].fitness_values[0] < 1e50


class TestCheckpointResume:
    def test_resume_across_levels_per_run_boundary(self, tmp_path):
        """Resuming from a checkpoint taken during the finest run must
        restore the coarser run's evolved cycle from the accumulated
        program (reference program.py:794-820) instead of re-evolving it."""
        problem = poisson_2d(min_level=3, max_level=7, dtype=jnp.float64)
        opt = make_optimizer(problem, seed=11, ckpt=str(tmp_path))
        best, program, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=2, generations=2,
            generalization_interval=100, optimization_method=opt.SOGP,
            evaluation_samples=1, maximum_local_system_size=4,
            levels_per_run=2, checkpoint_frequency=1, verbose=False,
        )
        assert len(hofs) == 2
        coarse_entry = program.split("# level range [5, 7]")[0]
        assert coarse_entry.startswith("# level range [3, 5]")

        problem2 = poisson_2d(min_level=3, max_level=7, dtype=jnp.float64)
        opt2 = make_optimizer(problem2, seed=77, ckpt=str(tmp_path))
        best2, program2, pops2, logs2, hofs2 = opt2.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=2, generations=2,
            generalization_interval=100, optimization_method=opt2.SOGP,
            evaluation_samples=1, maximum_local_system_size=4,
            levels_per_run=2, checkpoint_frequency=1,
            continue_from_checkpoint=True, verbose=False,
        )
        # Only the finest run re-ran (the coarser one was restored, and a
        # different RNG seed would have produced a different tree had it
        # been re-evolved).
        assert len(hofs2) == 1
        assert program2.startswith(coarse_entry)
        assert "# level range [5, 7]" in program2
        assert hofs2[-1][0].fitness_values[0] < 1e50


class TestGeneralizationRamp:
    def test_problem_size_ramp_reevaluates(self, tmp_path):
        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        opt = make_optimizer(problem, seed=5, ckpt=str(tmp_path))
        best, program, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=3, lambda_=3, population_initialization_factor=1, generations=3,
            generalization_interval=1,  # grow the problem every generation
            optimization_method=opt.SOGP, evaluation_samples=1,
            maximum_local_system_size=4, verbose=False,
        )
        # After two ramps the program generator evaluates at max_level+2.
        assert opt.program_generator.problem.max_level == 6
        assert hofs[-1][0].fitness_values[0] < 1e50


class TestKrylovCoarseSolver:
    def test_cg_expression_cgs(self):
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
            5, problem.equations, problem.operators, problem.fields, depth=1,
            maximum_local_system_size=4,
        )
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator
        cg = krylov.generate_conjugate_gradient(t0.coarse_operator, 40)
        cycle = generate_v_22_cycle_two_grid(t0, f)
        # Replace the dense CGS with a CG solve via the solver expression.
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)

        def rebuild_with_krylov():
            from evostencils_tpu.ir import partitioning as part, smoother

            ucur = u
            for _ in range(2):
                res = base.Residual(A, ucur, f)
                corr = base.Multiplication(
                    base.Inverse(smoother.generate_collective_jacobi(A)), res
                )
                ucur = base.Cycle(ucur, f, corr, partitioning=part.RedBlack,
                                  relaxation_factor=1.0)
            res = base.Residual(A, ucur, f)
            f_c = base.Multiplication(t0.restriction, res)
            cgs = base.CoarseGridSolver("CGS", t0.coarse_operator, cg)
            corr = base.Multiplication(
                t0.prolongation, base.Multiplication(cgs, f_c)
            )
            ucur = base.Cycle(ucur, f, corr, relaxation_factor=1.0)
            for _ in range(2):
                res = base.Residual(A, ucur, f)
                corr = base.Multiplication(
                    base.Inverse(smoother.generate_collective_jacobi(A)), res
                )
                ucur = base.Cycle(ucur, f, corr, partitioning=part.RedBlack,
                                  relaxation_factor=1.0)
            return ucur

        _, rho_krylov, _ = gen.generate_and_evaluate(
            rebuild_with_krylov(), evaluation_samples=1
        )
        _, rho_dense, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho_krylov < 0.1
        assert abs(rho_krylov - rho_dense) < 0.05


class TestDispatch:
    def test_thread_pool_dispatcher_results_ordered(self):
        from evostencils_tpu.parallel.dispatch import ThreadPoolDispatcher

        d = ThreadPoolDispatcher(max_workers=4)
        out = d.map(lambda x: x * x, list(range(20)))
        assert out == [x * x for x in range(20)]

    def test_optimizer_with_dispatcher(self, tmp_path):
        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        opt = make_optimizer(problem, seed=3, ckpt=str(tmp_path))
        from evostencils_tpu.parallel.dispatch import ThreadPoolDispatcher

        opt._dispatcher = ThreadPoolDispatcher(max_workers=2)
        best, *_ , hofs = opt.evolutionary_optimization(
            mu_=3, lambda_=3, population_initialization_factor=1, generations=1,
            generalization_interval=100, optimization_method=opt.SOGP,
            evaluation_samples=1, maximum_local_system_size=4, verbose=False,
        )
        assert hofs[-1][0].fitness_values is not None


class TestRelaxationTuning:
    def test_gradient_tuning_improves_rho(self):
        """Differentiate log-contraction through the whole lowered solve
        w.r.t. the relaxation-factor vector (JAX-native capability the
        reference approximated by patching generated C++ globals)."""
        from evostencils_tpu.ir import partitioning as part, smoother
        from evostencils_tpu.optimization.relaxation import tune_relaxation_factors

        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
            5, problem.equations, problem.operators, problem.fields, depth=1,
            maximum_local_system_size=4,
        )
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator

        def smooth_step(ucur, w):
            res = base.Residual(A, ucur, f)
            corr = base.Multiplication(
                base.Inverse(smoother.generate_collective_jacobi(A)), res
            )
            return base.Cycle(ucur, f, corr, partitioning=part.Single,
                              relaxation_factor=w)

        ucur = smooth_step(u, 0.3)
        res = base.Residual(A, ucur, f)
        f_c = base.Multiplication(t0.restriction, res)
        cgc = base.Multiplication(
            base.CoarseGridSolver("CGS", t0.coarse_operator), f_c
        )
        corr = base.Multiplication(t0.prolongation, cgc)
        ucur = base.Cycle(ucur, f, corr, relaxation_factor=0.3)
        expr = smooth_step(ucur, 0.3)

        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho_before, _ = gen.generate_and_evaluate(expr, evaluation_samples=1)
        tuned, _ = tune_relaxation_factors(expr, problem, iterations=50)
        gen._solver_cache.clear()
        _, rho_after, _ = gen.generate_and_evaluate(expr, evaluation_samples=1)
        assert rho_after < rho_before * 0.7
        assert all(0.1 <= w <= 1.9 for w in tuned)


class TestOuterRelaxationTuning:
    def test_cmaes_outer_tuning_does_not_regress(self):
        """CMA-ES over the preconditioner's ω vector against the measured
        outer BiCGStab iteration count (k=20 two-grid Helmholtz on CPU).
        The executable is compiled once; every candidate re-executes it
        with a different traced ω vector."""
        from evostencils_tpu.ir.reference_cycles import generate_v_cycle
        from evostencils_tpu.optimization.relaxation import tune_outer_relaxation
        from evostencils_tpu.problems.helmholtz import helmholtz_2d

        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0,
                               dtype=jnp.complex128)
        problem = problem._clone(
            outer_solver=dict(problem.outer_solver, max_iterations=1500)
        )
        _, terminals = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=2,
            maximum_local_system_size=4,
        )
        # Deliberately detuned: ω=1.3 overshoots for shifted-Laplace RBGS.
        expr = generate_v_cycle(terminals, problem.rhs(), 1, 1, omega=1.3)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        _, _, it_before = gen.generate_and_evaluate(expr, evaluation_samples=1)
        tuned, it_after = tune_outer_relaxation(
            expr, gen, iterations=3, sigma=0.2, seed=5
        )
        assert math.isfinite(it_after)
        assert it_after <= it_before + 1
        assert all(0.1 <= w <= 1.9 for w in tuned)
        # The winning ω really are written back into the expression.
        _, _, it_re = gen.generate_and_evaluate(expr, evaluation_samples=1)
        assert abs(it_re - it_after) <= max(3, 0.05 * it_after)


class TestSeeding:
    def test_seed_individual_enters_initial_population(self, tmp_path):
        """A seeded textbook string must be parsed into the generation-0
        population and (being far better than random trees at tiny
        budgets) win the run."""
        import jax.numpy as jnp
        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.grammar.multigrid import (
            generate_primitive_set, textbook_cycle_string,
        )
        from evostencils_tpu.optimization.optimizer import Optimizer
        from evostencils_tpu.problems.poisson import poisson_2d

        problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, 5, problem.equations,
            problem.operators, problem.fields, depth=2,
            maximum_local_system_size=4,
        )
        seed = textbook_cycle_string(tl, 2, 1, omega_index=16)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        opt = Optimizer.for_problem(
            problem, program_generator=gen,
            checkpoint_directory_path=str(tmp_path),
            rng=random.Random(5),
        )
        best, _, _, _, hofs = opt.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=1,
            generations=1, generalization_interval=100,
            optimization_method=opt.SOGP, evaluation_samples=1,
            maximum_local_system_size=4, seed_individuals=[seed],
            verbose=False,
        )
        # The seed (or an ω-mutation of it) dominates a 1-generation run.
        assert any(str(ind) == seed for hof in hofs for ind in hof)


class TestFailureFitnessOrdering:
    def test_capped_failure_ranks_below_converged_time(self, tmp_path):
        """A non-converged individual (capped outer solve, small measured
        iteration count) must never outrank a converged individual whose
        fitness is a time-to-convergence in milliseconds."""
        problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
        opt = make_optimizer(problem, ckpt=str(tmp_path))
        results = iter([
            (3600.0, 0.96, 450),          # converged: 3.6 s to target
            (1e100, 0.99, 600),           # capped at 600 iterations
        ])
        opt._program_generator.generate_and_evaluate = (
            lambda *a, **k: next(results)
        )
        opt.compile_individual = lambda ind: (object(), None)

        class Ind(str):
            pass

        converged = opt.evaluate_single_objective(Ind("a"), 1)
        failed = opt.evaluate_single_objective(Ind("b"), 1)
        assert converged[0] == 3600.0
        assert failed[0] > converged[0]
        assert failed[0] < opt.infinity
        # Relative ordering among failures still follows sqrt(rho*iters).
        worse = (Optimizer.FAILURE_FITNESS_OFFSET
                 + (0.999 * 10000) ** 0.5)
        assert failed[0] < worse
