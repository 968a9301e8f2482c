"""Problem-family tests: elasticity (block system), Helmholtz (complex +
outer Krylov), FAS (nonlinear) — the reference's four example_problems."""

import jax.numpy as jnp
import numpy as np
import pytest

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering
from evostencils_tpu.grammar import gp
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, partitioning as part, smoother
from evostencils_tpu.ir.reference_cycles import (
    generate_v_22_cycle_two_grid,
    generate_v_cycle,
)
from evostencils_tpu.problems.elasticity import linear_elasticity_2d
from evostencils_tpu.problems.fas import NonlinearLambdaExpGenerator, _solution, fas_2d
from evostencils_tpu.problems.helmholtz import helmholtz_2d, helmholtz_ladder


def build_pset(problem, depth, fas=False):
    return generate_primitive_set(
        problem.approximation(),
        problem.rhs(),
        problem.dimension,
        problem.coarsening_factors,
        problem.max_level,
        problem.equations,
        problem.operators,
        problem.fields,
        depth=depth,
        maximum_local_system_size=4,
        FAS=fas,
    )


class TestElasticity:
    def test_two_grid_converges(self):
        problem = linear_elasticity_2d(min_level=3, max_level=4, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        cycle = generate_v_22_cycle_two_grid(terminals[0], problem.rhs(), omega=0.8)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.5
        assert iters < 100

    def test_system_operator_block_structure(self):
        problem = linear_elasticity_2d(min_level=3, max_level=4, dtype=jnp.float64)
        A = problem.finest_operator()
        assert len(A.entries) == 2 and len(A.entries[0]) == 2
        # Off-diagonal coupling (λ+μ)·dxy must be present and symmetric.
        s01 = A.entries[0][1].generate_stencil()
        s10 = A.entries[1][0].generate_stencil()
        from evostencils_tpu.stencils import periodic

        assert periodic.lift(s01).as_constant() == periodic.lift(s10).as_constant()

    def test_decoupled_vs_collective_smoother(self):
        problem = linear_elasticity_2d(min_level=3, max_level=4, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)

        def cycle_with(factory):
            ucur = u
            for _ in range(2):
                res = base.Residual(A, ucur, f)
                corr = base.Multiplication(base.Inverse(factory(A)), res)
                ucur = base.Cycle(ucur, f, corr, partitioning=part.RedBlack,
                                  relaxation_factor=0.8)
            res = base.Residual(A, ucur, f)
            f_c = base.Multiplication(t0.restriction, res)
            cgc = base.Multiplication(
                base.CoarseGridSolver("CGS", t0.coarse_operator), f_c
            )
            corr = base.Multiplication(t0.prolongation, cgc)
            return base.Cycle(ucur, f, corr, relaxation_factor=1.0)

        _, rho_dec, _ = gen.generate_and_evaluate(
            cycle_with(smoother.generate_decoupled_jacobi), evaluation_samples=1
        )
        _, rho_col, _ = gen.generate_and_evaluate(
            cycle_with(smoother.generate_collective_jacobi), evaluation_samples=1
        )
        assert rho_dec < 1.0 and rho_col < 1.0


class TestHelmholtz:
    def test_preconditioned_bicgstab_converges(self):
        # Small instance: k=20 on a 32² grid keeps kh ≈ 0.625.
        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0, dtype=jnp.complex128)
        _, terminals = build_pset(problem, depth=2)
        cycle = generate_v_cycle(
            terminals, problem.rhs(), pre_smoothing=2, post_smoothing=1, omega=0.6
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert iters < 500
        assert rho < 1.0
        assert t < 1e50

    def test_outer_solver_rides_the_cycle_vm(self):
        """Helmholtz evaluation must take the compile-free VM path: two
        structurally different preconditioner cycles share ONE outer-solve
        executable (the round-3 economics fix — zero per-structure
        compiles during Helmholtz evolution)."""
        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0, dtype=jnp.complex128)
        _, terminals = build_pset(problem, depth=2)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        c21 = generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=0.6)
        c12 = generate_v_cycle(terminals, problem.rhs(), 1, 2, omega=0.7)
        t1, rho1, it1 = gen.generate_and_evaluate(c21, evaluation_samples=1)
        t2, rho2, it2 = gen.generate_and_evaluate(c12, evaluation_samples=1)
        assert rho1 < 1.0 and rho2 < 1.0
        assert gen.vm_hits >= 2 and gen.vm_misses == 0
        full_keys = [
            k for k in gen._solver_cache
            if isinstance(k, tuple) and k[0] == "__vm__" and "outer" in k
        ]
        assert len(full_keys) >= 1
        # No per-structure ("outer", ...) structural keys were compiled.
        assert not any(
            isinstance(k, tuple) and k[0] == "outer" for k in gen._solver_cache
        )

    def test_k320_champion_regression(self):
        """Pin the round-5 k=320 evolved champion (RESULTS R5.9): the
        single collective-Jacobi sweep must still converge the k=320
        outer BiCGStab to 1e-7 well under the default 10000 cap
        (measured 6515 outer its / 4.13 s; the per-k tuned textbook
        V(2,2) needs 2246 its but 4.7× the time).  Reference ladder
        anchor: scripts/optimize.py:34-37."""
        import random

        from evostencils_tpu.optimization.optimizer import Optimizer

        with open("artifacts/helmholtz_k320_r5/individual_0.txt") as f:
            champion = "".join(
                line for line in f if not line.startswith("#")
            ).strip()
        problem = helmholtz_2d(min_level=3, max_level=7, k=320.0,
                               dtype=jnp.complex128)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        opt = Optimizer.for_problem(
            problem, program_generator=gen, rng=random.Random(0)
        )
        t, _, iters = (
            opt.generate_and_evaluate_program_from_grammar_representation(
                champion, 4, evaluation_samples=1
            )
        )
        assert t < 1e50
        assert iters <= 8000

    def test_probe_kills_hopeless_preconditioner_without_full_solve(self):
        """A divergent preconditioner must die at the short probe stage
        with an informative (finite-or-ordered) ρ, and the full-cap outer
        solve must never be built for it."""
        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0, dtype=jnp.complex128)
        # Tight budget: reaching 1e-7 within 2×9 projected iterations needs
        # a sustained 0.41 contraction over the 2-iteration probe — nothing
        # this preconditioner can do, so the kill is deterministic.
        problem.outer_solver["probe_iterations"] = 2
        problem.outer_solver["max_iterations"] = 9
        _, terminals = build_pset(problem, depth=2)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        # ω=1.9 plain Jacobi with no coarse correction diverges on M.
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator
        from evostencils_tpu.ir import smoother as sm

        res = base.Residual(A, u, f)
        corr = base.Multiplication(
            base.Inverse(sm.generate_collective_jacobi(A)), res
        )
        bad = base.Cycle(u, f, corr, partitioning=part.Single,
                         relaxation_factor=1.9)
        t, rho, iters = gen.generate_and_evaluate(bad, evaluation_samples=1)
        assert t == 1e100
        assert iters >= problem.outer_solver["max_iterations"]
        assert 0 < rho  # informative, ordered failure fitness
        probe_keys = [
            k for k in gen._solver_cache
            if isinstance(k, tuple) and any(
                isinstance(p, str) and p.startswith("outer_probe") for p in k
            )
        ]
        assert probe_keys, "probe solver was never built"
        # The full-cap solver was never compiled for the killed individual.
        assert not any(
            isinstance(k, tuple) and ("outer" in k or k[0] == "outer")
            for k in gen._solver_cache
        )

    def test_probe_survivor_seeds_staged_solve(self):
        """A converging preconditioner must SURVIVE the probe prescreen and
        reuse the probe's iterations: the staged solve starts from the
        probe solution (round-3 fix — up to `probe` outer iterations were
        recomputed from zero), and the reported total stays consistent
        with convergence to the true target."""
        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0,
                               dtype=jnp.complex128)
        problem.outer_solver["probe_iterations"] = 8
        problem.outer_solver["max_iterations"] = 500
        _, terminals = build_pset(problem, depth=2)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        good = generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=0.6)
        t, rho, iters = gen.generate_and_evaluate(good, evaluation_samples=1)
        assert t < 1e50  # converged, not poisoned
        assert rho < 1.0
        # The probe ran (8 its) and its work is part of the total.
        assert iters >= 8
        probe_keys = [
            k for k in gen._solver_cache
            if isinstance(k, tuple) and any(
                isinstance(p, str) and p.startswith("outer_probe") for p in k
            )
        ]
        assert probe_keys, "probe solver was never built"
        full_keys = [
            k for k in gen._solver_cache
            if isinstance(k, tuple) and "outer" in k
            and not any(isinstance(p, str) and p.startswith("outer_probe")
                        for p in k)
        ]
        assert full_keys, "full-cap solver missing for the survivor"

    def test_ladder(self):
        ladder = helmholtz_ladder(3)
        assert [k for k, _ in ladder] == [80.0, 160.0, 320.0]
        for k, level in ladder:
            h = 2.0**-level
            assert abs(h * k - 0.625) < 0.2

    def test_shifted_operator_is_complex(self):
        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0)
        M = problem.finest_operator()
        stencil = M.entries[0][0].generate_stencil()
        from evostencils_tpu.stencils import periodic

        center = periodic.lift(stencil).as_constant().center_value()
        assert abs(complex(center).imag) > 0


class TestFAS:
    def _newton_v22(self, problem, terminals):
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator

        def sm(uin, steps):
            for _ in range(steps):
                res = base.Residual(A, uin, f)
                B = smoother.generate_jacobi_newton(A, 1)
                corr = base.Multiplication(base.Inverse(B), res)
                uin = base.Cycle(uin, f, corr, partitioning=part.RedBlack,
                                 relaxation_factor=0.8)
            return uin

        u2 = sm(u, 2)
        res = base.Residual(A, u2, f)
        Ru = base.Multiplication(t0.restriction, u2)
        f_c = base.Addition(
            base.Multiplication(t0.restriction, res),
            base.Multiplication(t0.coarse_operator, Ru),
        )
        sol_c = base.Multiplication(
            base.CoarseGridSolver("CGS", t0.coarse_operator), f_c
        )
        corr = base.Multiplication(t0.prolongation, base.Subtraction(sol_c, Ru))
        u3 = base.Cycle(u2, f, corr, relaxation_factor=1.0)
        return sm(u3, 2)

    def test_newton_two_grid_converges_fast(self):
        problem = fas_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1, fas=True)
        cycle = self._newton_v22(problem, terminals)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.1
        assert iters < 15

    def test_solves_manufactured_solution(self):
        problem = fas_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1, fas=True)
        cycle = self._newton_v22(problem, terminals)
        lowering = CycleLowering(jnp.float64)
        step = lowering.lower(cycle)
        u, f = problem.initial_state(jnp.float64)
        for _ in range(20):
            u = step(u, f)
        x, y = problem.interior_coordinates(5)
        err = np.max(np.abs(np.asarray(u[0]) - _solution(x, y)))
        assert err < 5e-3  # discretization error at h=1/32

    def test_fas_grammar_productions(self, rng):
        problem = fas_2d(min_level=3, max_level=5, dtype=jnp.float64)
        pset, _ = build_pset(problem, depth=2, fas=True)
        names = set(pset.mapping)
        assert any(n.startswith("jacobi_newton_0") for n in names)
        assert any(n.startswith("jacobi_picard_0") for n in names)
        assert not any(n.startswith("collective_block_jacobi") for n in names)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        evaluated = 0
        for _ in range(4):
            tree = gp.gen_grow(pset, 2, 10, rng=rng)
            expr, _ = gp.compile_tree(tree, pset)
            t, rho, iters = gen.generate_and_evaluate(expr, evaluation_samples=1)
            assert rho > 0
            evaluated += 1
        assert evaluated == 4

    def test_protocol_champion_regression(self):
        """Pin the round-5 protocol-scale FAS champion (SOGP, μ=λ=16 × 20
        generations, 512² levels 5–9): the stored grammar string must
        re-parse through the FAS pset and keep beating the textbook FAS
        V(2,2) baselines (n=20 medians recorded when it was evolved:
        champion ρ 0.187 / 14 its vs Newton 0.577 / 42, Picard 0.515 /
        35.5).  Reference protocol anchor:
        code_generation/exastencils_FAS.py:369-426."""
        import random

        from evostencils_tpu.optimization.optimizer import Optimizer

        with open("artifacts/fas_champion_r5.txt") as f:
            champion = "".join(
                line for line in f if not line.startswith("#")
            ).strip()
        problem = fas_2d(min_level=5, max_level=9, dtype=jnp.float64)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        opt = Optimizer.for_problem(
            problem, program_generator=gen, rng=random.Random(0)
        )
        _, rho, iters = opt.generate_and_evaluate_program_from_grammar_representation(
            champion, 8, evaluation_samples=1
        )
        assert rho < 0.25
        assert iters <= 16

    def test_nonlinear_generator_protocol(self):
        gen = NonlinearLambdaExpGenerator(gamma=20.0)
        u = jnp.asarray(np.linspace(-1, 1, 16).reshape(4, 4))
        n = gen.nonlinear_term(u)
        d = gen.derivative_diag(u)
        np.testing.assert_allclose(
            np.asarray(n), 20.0 * np.asarray(u) * np.exp(np.asarray(u)), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(d),
            20.0 * (1 + np.asarray(u)) * np.exp(np.asarray(u)),
            rtol=1e-6,
        )


class TestHelmholtzLadder:
    def test_k_ladder_generalization(self, tmp_path):
        """Generalization ramp + PDE-parameter ladder: k doubles as the
        grid refines (h·k fixed), mirroring the reference protocol
        (scripts/optimize.py:34-37)."""
        import random

        from evostencils_tpu.optimization.optimizer import Optimizer

        problem = helmholtz_2d(min_level=3, max_level=4, k=5.0, dtype=jnp.complex128)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        opt = Optimizer.for_problem(
            problem, program_generator=gen,
            checkpoint_directory_path=str(tmp_path), rng=random.Random(6),
        )
        best, prog, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=3, lambda_=3, population_initialization_factor=1, generations=2,
            generalization_interval=1, optimization_method=opt.SOGP,
            evaluation_samples=1, maximum_local_system_size=4,
            pde_parameter_values={"k": [5.0, 10.0]}, verbose=False,
        )
        assert opt.program_generator.problem.parameters["k"] == 10.0
        assert opt.program_generator.problem.max_level == 5
        assert hofs[-1][0].fitness_values is not None


class TestHelmholtzRobin:
    def test_robin_boundary_converges(self):
        """First-order radiation BCs folded into boundary-adjacent stencil
        rows (variable complex coefficients)."""
        problem = helmholtz_2d(min_level=3, max_level=4, k=10.0,
                               boundary="robin", dtype=jnp.complex128)
        _, terminals = build_pset(problem, depth=1)
        cycle = generate_v_cycle(
            [terminals[0]], problem.rhs(), pre_smoothing=2, post_smoothing=1,
            omega=0.6,
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert iters < 500
        assert t < 1e50

    def test_robin_planes_modify_boundary_rows(self):
        from evostencils_tpu.stencils.gallery import Helmholtz2D, Helmholtz2DRobin
        from evostencils_tpu.ir.base import Grid

        grid = Grid((16, 16), (1 / 16, 1 / 16), 4)
        offsets, planes = Helmholtz2DRobin(10.0, 1.0).generate_coefficient_arrays(grid)
        center = planes[offsets.index((0, 0))]
        interior_val = Helmholtz2D(10.0, 1.0).generate_stencil(grid).center_value()
        assert np.allclose(center[5, 5], interior_val)
        assert center[0, 5] != center[5, 5]  # boundary-adjacent row modified
        assert abs(center[0, 5].imag) > 0  # complex radiation term


class TestInitialStateSeed:
    def test_rhs_seed_overrides_physical_rhs(self):
        """rhs_seed forces a seeded random RHS even on problems with
        physical RHS functions (sample-spread re-measurement protocol)."""
        from evostencils_tpu.problems.poisson import poisson_2d

        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        _, f_phys = problem.initial_state(jnp.float64)
        _, f_a = problem.initial_state(jnp.float64, rhs_seed=1)
        _, f_b = problem.initial_state(jnp.float64, rhs_seed=2)
        _, f_a2 = problem.initial_state(jnp.float64, rhs_seed=1)
        assert not np.allclose(np.asarray(f_a[0]), np.asarray(f_phys[0]))
        assert not np.allclose(np.asarray(f_a[0]), np.asarray(f_b[0]))
        np.testing.assert_array_equal(np.asarray(f_a[0]), np.asarray(f_a2[0]))

    def test_init_seed_randomizes_guess_keeps_physical_rhs(self):
        """init_seed randomizes the INITIAL GUESS and keeps the physical
        RHS — the convergent spread protocol for indefinite problems
        (scripts/champion_stats.py --vary init)."""
        from evostencils_tpu.problems.poisson import poisson_2d

        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        u0_zero, f_phys = problem.initial_state(jnp.float64)
        u_a, f_a = problem.initial_state(jnp.float64, init_seed=1)
        u_b, _ = problem.initial_state(jnp.float64, init_seed=2)
        u_a2, _ = problem.initial_state(jnp.float64, init_seed=1)
        np.testing.assert_array_equal(np.asarray(f_a[0]), np.asarray(f_phys[0]))
        assert not np.allclose(np.asarray(u_a[0]), np.asarray(u0_zero[0]))
        assert not np.allclose(np.asarray(u_a[0]), np.asarray(u_b[0]))
        np.testing.assert_array_equal(np.asarray(u_a[0]), np.asarray(u_a2[0]))

    def test_init_seed_outer_solve_converges_with_spread(self):
        """On the outer-Krylov (Helmholtz) path the init-seed protocol
        solves the host error equation A·e = f − A·x0 with zero device
        stage guesses: the solve still CONVERGES (a random RHS would
        stagnate at k≥160 — near-resonant energy) and distinct seeds give
        distinct measurements."""
        from evostencils_tpu.ir.reference_cycles import generate_v_cycle

        problem = helmholtz_2d(min_level=3, max_level=5, k=20.0,
                               dtype=jnp.complex128)
        _, terminals = build_pset(problem, depth=2)
        cycle = generate_v_cycle(terminals, problem.rhs(),
                                 pre_smoothing=2, post_smoothing=1, omega=0.6)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        gen.init_seed = 3
        _, rho3, it3 = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        gen.init_seed = 4
        _, rho4, it4 = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        gen.init_seed = None
        assert rho3 < 1.0 and rho4 < 1.0
        assert it3 < 500 and it4 < 500
        assert (it3, rho3) != (it4, rho4)
