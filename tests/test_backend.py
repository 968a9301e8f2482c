"""Golden numerics tests: IR lowering against textbook multigrid behavior."""

import jax.numpy as jnp
import numpy as np
import pytest

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, partitioning as part, reference_cycles, smoother
from evostencils_tpu.ops import intergrid, stencil_ops as sops
from evostencils_tpu.problems.poisson import poisson_2d, poisson_2d_variable, poisson_3d
from evostencils_tpu.stencils import constant, gallery


def build_pset(problem, depth):
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
    )


class TestStencilApply:
    def test_laplace_of_sine_is_eigenfunction(self):
        # A sin(pi x)sin(pi y) is an eigenvector of the discrete Laplacian.
        level = 5
        n = 2**level
        h = 1.0 / n
        x = np.arange(1, n) * h
        X, Y = np.meshgrid(x, x, indexing="ij")
        u = jnp.asarray(np.sin(np.pi * X) * np.sin(np.pi * Y))
        grid = base.Grid((n, n), (h, h), level)
        stencil = gallery.Poisson2D().generate_stencil(grid)
        out = sops.apply_constant_stencil(u, stencil)
        eig = 8.0 / (h * h) * np.sin(np.pi * h / 2) ** 2  # both axes contribute
        np.testing.assert_allclose(np.asarray(out), eig * np.asarray(u), rtol=1e-9)

    def test_restrict_prolong_adjointness(self):
        # Full-weighting R = (1/2^d) P^T: check <P uc, uf> == 2^d <uc, R uf>.
        rng = np.random.default_rng(0)
        fine_shape, coarse_shape = (15, 15), (7, 7)
        uf = jnp.asarray(rng.standard_normal(fine_shape))
        uc = jnp.asarray(rng.standard_normal(coarse_shape))
        p_stencil = gallery.multilinear_interpolation_stencil(2)
        r_stencil = gallery.full_weighting_restriction_stencil(2)
        Puc = intergrid.prolong(uc, p_stencil, fine_shape, (2, 2))
        Ruf = intergrid.restrict(uf, r_stencil, coarse_shape, (2, 2))
        lhs = float(jnp.sum(Puc * uf))
        rhs = 4.0 * float(jnp.sum(uc * Ruf))
        assert abs(lhs - rhs) < 1e-9

    def test_prolong_of_constant_interior(self):
        # Bilinear interpolation reproduces constants away from boundary.
        uc = jnp.ones((7, 7))
        p_stencil = gallery.multilinear_interpolation_stencil(2)
        out = np.asarray(intergrid.prolong(uc, p_stencil, (15, 15), (2, 2)))
        np.testing.assert_allclose(out[2:-2, 2:-2], 1.0, atol=1e-12)


class TestCycles:
    def test_two_grid_v22_rbgs(self):
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        cycle = reference_cycles.generate_v_22_cycle_two_grid(
            terminals[0], problem.rhs()
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.05
        assert iters < 15

    def test_three_grid_v22(self):
        problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=2)
        cycle = reference_cycles.generate_v_22_cycle_three_grid(
            terminals[0], terminals[1], problem.rhs()
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.1

    def test_jacobi_smoother_only_diverges_slowly(self):
        # Pure damped Jacobi: ρ = 1 - O(h²); must be < 1 but near 1.
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator
        res = base.Residual(A, u, f)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(A)), res
        )
        cycle = base.Cycle(u, f, corr, partitioning=part.Single, relaxation_factor=0.8)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64, iteration_limit=60)
        _, rho, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        h = 2.0**-5
        expected = 1 - 0.8 * (1 - np.cos(np.pi * h))  # smooth-mode damping
        assert rho < 1.0
        assert abs(rho - expected) < 0.02

    def test_omega_jacobi_optimal_damping(self):
        # ω=0.8 damped Jacobi V(1,1)-free smoother factor sanity: the
        # measured ρ of a two-grid with 1 pre-smooth should be around the
        # textbook smoothing factor ~0.6 (loose bounds).
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator
        res = base.Residual(A, u, f)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(A)), res
        )
        u1 = base.Cycle(u, f, corr, partitioning=part.Single, relaxation_factor=0.8)
        res1 = base.Residual(A, u1, f)
        f_c = base.Multiplication(t0.restriction, res1)
        cgc = base.Multiplication(base.CoarseGridSolver("CGS", t0.coarse_operator), f_c)
        corr1 = base.Multiplication(t0.prolongation, cgc)
        cycle = base.Cycle(u1, f, corr1, relaxation_factor=1.0)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert 0.3 < rho < 0.75

    def test_three_d_two_grid(self):
        problem = poisson_3d(min_level=2, max_level=3, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        cycle = reference_cycles.generate_v_22_cycle_two_grid(
            terminals[0], problem.rhs()
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.1

    def test_variable_coefficient_two_grid(self):
        problem = poisson_2d_variable(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        cycle = reference_cycles.generate_v_22_cycle_two_grid(
            terminals[0], problem.rhs()
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert rho < 0.2

    def test_fas_two_grid_on_linear_problem(self):
        # On a linear problem FAS must reproduce the plain CGC result.
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        fas = reference_cycles.generate_fas_v_22_cycle_two_grid(
            terminals[0], problem.rhs()
        )
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho_fas, _ = gen.generate_and_evaluate(fas, evaluation_samples=1)
        plain = reference_cycles.generate_v_22_cycle_two_grid(
            terminals[0], problem.rhs()
        )
        _, rho_plain, _ = gen.generate_and_evaluate(plain, evaluation_samples=1)
        assert rho_fas < 0.1
        assert abs(rho_fas - rho_plain) < 0.05

    def test_red_black_beats_plain_jacobi(self):
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)

        def vcycle(partitioning, omega):
            return reference_cycles.generate_v_22_cycle_two_grid(
                terminals[0], problem.rhs(), omega=omega, partitioning=partitioning
            )

        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho_rb, _ = gen.generate_and_evaluate(vcycle(part.RedBlack, 1.0), evaluation_samples=1)
        _, rho_j, _ = gen.generate_and_evaluate(vcycle(part.Single, 0.8), evaluation_samples=1)
        assert rho_rb < rho_j


class TestBlockSmoother:
    def test_block_jacobi_two_grid(self):
        problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
        _, terminals = build_pset(problem, depth=1)
        t0 = terminals[0]
        u, f, A = t0.approximation, problem.rhs(), t0.operator

        def smooth(u, steps):
            for _ in range(steps):
                res = base.Residual(A, u, f)
                B = smoother.generate_collective_block_jacobi(A, ((2, 2),))
                corr = base.Multiplication(base.Inverse(B), res)
                u = base.Cycle(u, f, corr, partitioning=part.Single, relaxation_factor=0.9)
            return u

        u1 = smooth(u, 2)
        res = base.Residual(A, u1, f)
        f_c = base.Multiplication(t0.restriction, res)
        cgc = base.Multiplication(base.CoarseGridSolver("CGS", t0.coarse_operator), f_c)
        corr = base.Multiplication(t0.prolongation, cgc)
        u2 = base.Cycle(u1, f, corr, relaxation_factor=1.0)
        u3 = smooth(u2, 2)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        _, rho, _ = gen.generate_and_evaluate(u3, evaluation_samples=1)
        assert rho < 0.3

    def test_block_solve_is_exact_on_block_system(self):
        """2x2 block Jacobi with the full operator being block-diagonal
        must solve in one step (ρ ≈ 0 up to roundoff)."""
        from evostencils_tpu.ops.smoothers import build_block_solve_spec
        from evostencils_tpu.stencils import periodic as per

        grid = base.Grid((8, 8), (0.125, 0.125), 3)
        stencil = gallery.Poisson2D().generate_stencil(grid)
        bd = per.block_diagonal(stencil, (2, 2))
        spec = build_block_solve_spec([[bd]], [(2, 2)], (8, 8), jnp.float64)
        rng = np.random.default_rng(3)
        r = (jnp.asarray(rng.standard_normal((8, 8))),)
        corr = spec.apply(r)[0]
        # verify B corr == r where B is the block-diagonal operator
        back = sops.apply_periodic_stencil(corr, bd)
        np.testing.assert_allclose(np.asarray(back), np.asarray(r[0]), rtol=1e-10)

    @pytest.mark.parametrize(
        "block,shape",
        [(((2, 2),), (9, 13)), (((4, 2),), (11, 10)), (((1, 8),), (16, 9)),
         (((3, 1),), (7, 7))],
    )
    def test_masked_shift_apply_matches_matmul(self, block, shape):
        """The masked-shift formulation must equal the plain numpy
        block-by-block solve (ops/reference.block_solve) up to f64
        roundoff, including truncated boundary blocks on non-divisible
        shapes.  (The name predates the removal of the matmul path.)"""
        from evostencils_tpu.ops import reference as ref
        from evostencils_tpu.ops.smoothers import build_block_solve_spec
        from evostencils_tpu.stencils import periodic as per

        grid = base.Grid(shape, (1.0 / shape[0], 1.0 / shape[1]), 3)
        stencil = gallery.Poisson2D().generate_stencil(grid)
        bd = per.block_diagonal(stencil, block[0])
        spec = build_block_solve_spec([[bd]], list(block), shape, jnp.float64)
        rng = np.random.default_rng(11)
        r = (jnp.asarray(rng.standard_normal(shape)),)
        got = spec.apply(r)[0]
        want = ref.block_solve([np.asarray(r[0])], spec.inv_l, block[0])[0]
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-13
        )

    def test_masked_shift_apply_matches_matmul_complex_system(self):
        """Complex dtype (Helmholtz) and a 2-field system exercise the
        inter-field shift planes, against the numpy reference."""
        from evostencils_tpu.ops import reference as ref
        from evostencils_tpu.ops.smoothers import build_block_solve_spec
        from evostencils_tpu.stencils import constant, periodic as per

        shape = (10, 11)
        grid = base.Grid(shape, (0.1, 0.1), 3)
        lap = gallery.Poisson2D().generate_stencil(grid)
        shifted = constant.combine(
            lap, constant.scale(-(1.0 + 0.5j), constant.get_unit_stencil(grid)),
            lambda a, b: a + b,
        )
        coupling = constant.scale(0.25j, constant.get_unit_stencil(grid))
        bd = per.block_diagonal(shifted, (2, 2))
        cp = per.block_diagonal(coupling, (2, 2))
        entries = [[bd, cp], [cp, bd]]
        spec = build_block_solve_spec(
            entries, [(2, 2), (2, 2)], shape, jnp.complex128
        )
        rng = np.random.default_rng(5)
        r = tuple(
            jnp.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            for _ in range(2)
        )
        got = spec.apply(r)
        want = ref.block_solve([np.asarray(x) for x in r], spec.inv_l, (2, 2))
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(w), rtol=1e-12, atol=1e-13
            )


class TestSmoothingChainFusion:
    """Consecutive same-structure smoothing steps lower to one lax.scan
    over their ω slice; the fused program must match the unrolled walk
    exactly (values and gradients), for both partitionings."""

    @pytest.mark.parametrize("partitioning", [part.RedBlack, part.Single])
    def test_fused_matches_unrolled(self, partitioning):
        import jax

        problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=2,
        )
        cycle = reference_cycles.generate_v_cycle(
            tl, problem.rhs(), pre_smoothing=3, post_smoothing=2, omega=0.9,
            partitioning=partitioning,
        )
        u0, f = problem.initial_state(jnp.float64)

        fused = CycleLowering(jnp.float64)
        plain = CycleLowering(jnp.float64)
        plain._smoothing_chain = lambda node, multiref: None

        chains = []
        orig = CycleLowering._smoothing_chain

        def counting(self, node, multiref):
            c = orig(self, node, multiref)
            if c is not None:
                chains.append(len(c))
            return c

        fused._smoothing_chain = counting.__get__(fused)

        got = jax.jit(fused.lower(cycle))(u0, f)
        exp = jax.jit(plain.lower(cycle))(u0, f)
        assert chains, "no smoothing chains were detected in a V(3,2) cycle"
        np.testing.assert_allclose(
            np.asarray(got[0]), np.asarray(exp[0]), rtol=1e-13, atol=1e-14
        )

        step_f, ov = fused.lower_parameterized(cycle)
        step_p, ov2 = plain.lower_parameterized(cycle)
        assert ov == ov2
        rng = np.random.default_rng(0)
        om = jnp.asarray(0.5 + rng.random(len(ov)), dtype=jnp.float64)
        np.testing.assert_allclose(
            np.asarray(step_f(u0, f, om)[0]),
            np.asarray(step_p(u0, f, om)[0]),
            rtol=1e-13, atol=1e-14,
        )

        def loss(stepper):
            return lambda o: sum(jnp.sum(x**2) for x in stepper(u0, f, o))

        np.testing.assert_allclose(
            np.asarray(jax.grad(loss(step_f))(om)),
            np.asarray(jax.grad(loss(step_p))(om)),
            rtol=1e-10,
        )


class TestPredictedStagedSolver:
    def test_predicted_stages_reach_target_and_track_rho(self):
        """Predicted-cycle stages (device_solve.build_predicted_staged_
        solver) must reach the 1e-10 target with cycle counts that shrink
        for smaller ρ — the property the reactive stall-hunting stages
        lost (round-2 headline: ~18-22 cycles regardless of ρ)."""
        import jax

        from evostencils_tpu.backend.device_solve import (
            staged_solver_for_expression,
        )
        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.backend.lowering import CycleLowering

        problem = poisson_2d(min_level=3, max_level=6, dtype=jnp.float32)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=3,
        )
        operator = tl[0].operator
        gen = JaxProgramGenerator(problem, dtype=jnp.float32)
        lowering32 = CycleLowering(jnp.float32)
        lowering64 = CycleLowering(jnp.float64)
        _, f32_rhs = problem.initial_state(jnp.float32)

        results = {}
        for name, pre, post, omega in (("v11", 1, 1, 0.8), ("v22", 2, 2, 1.0)):
            expr = reference_cycles.generate_v_cycle(
                tl, problem.rhs(), pre, post, omega=omega
            )
            _, rho, _ = gen.generate_and_evaluate(expr, evaluation_samples=1)
            assert 0 < rho < 1
            solve, f64_rhs = staged_solver_for_expression(
                lowering32, expr, operator, problem, gen,
                target=1e-10, lowering64=lowering64, rho=float(rho),
            )
            cycles, rel, stages = solve(f32_rhs, f64_rhs)
            assert rel <= 1e-10, f"{name}: rel={rel}"
            assert stages >= 2
            results[name] = (cycles, rho)
        # The much-better-ρ V(2,2) must use fewer cycles than V(1,1).
        assert results["v22"][1] < results["v11"][1]
        assert results["v22"][0] < results["v11"][0]

    def test_floor_calibration_reduces_stages(self):
        """calibrate_floor=True probes the ACTUAL f32 stage floor (way
        below the conservative 5e-3 default on small grids, where 1/h²
        is modest) and must therefore reach the target in fewer or equal
        stages and cycles, never worse."""
        from evostencils_tpu.backend.device_solve import (
            staged_solver_for_expression,
        )
        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.backend.lowering import CycleLowering

        problem = poisson_2d(min_level=3, max_level=6, dtype=jnp.float32)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=3,
        )
        operator = tl[0].operator
        gen = JaxProgramGenerator(problem, dtype=jnp.float32)
        lowering32 = CycleLowering(jnp.float32)
        lowering64 = CycleLowering(jnp.float64)
        _, f32_rhs = problem.initial_state(jnp.float32)
        expr = reference_cycles.generate_v_cycle(tl, problem.rhs(), 2, 2)
        _, rho, _ = gen.generate_and_evaluate(expr, evaluation_samples=1)

        outcomes = {}
        for calibrate in (False, True):
            solve, f64_rhs = staged_solver_for_expression(
                lowering32, expr, operator, problem, gen,
                target=1e-10, lowering64=lowering64, rho=float(rho),
                calibrate_floor=calibrate,
            )
            cycles, rel, stages = solve(f32_rhs, f64_rhs)
            assert rel <= 1e-10
            outcomes[calibrate] = (stages, cycles)
            if calibrate:
                assert solve.measured_floor is not None
                assert 0 < solve.measured_floor < 5e-3
        # Deeper measured floor → at most as many restarts.  (Cycle counts
        # are grid-size dependent: on tiny grids restart transients are
        # free and short stages can win; the 1024² headline is where the
        # stage economics matter and are re-measured.)
        assert outcomes[True][0] <= outcomes[False][0]
        # The remaining-decades cap must keep calibration from grossly
        # overshooting the target: within 2 cycles + one transient of the
        # uncalibrated count.
        assert outcomes[True][1] <= outcomes[False][1] + 3


_FIVE_POINT = constant.Stencil(
    [((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0),
     ((0, -1), -1.0)]
)
_NINE_POINT = constant.Stencil(
    [((i, j), 20.0 / 6 if (i, j) == (0, 0) else
      -4.0 / 6 if abs(i) + abs(j) == 1 else -1.0 / 6)
     for i in (-1, 0, 1) for j in (-1, 0, 1)]
)


@pytest.mark.parametrize("dtype,tolerance", [(jnp.float64, 1e-13), (jnp.float32, 2e-6)])
@pytest.mark.parametrize("shape", [(15, 15), (161, 96)])
@pytest.mark.parametrize("stencil", [_FIVE_POINT, _NINE_POINT], ids=["5pt", "9pt"])
def test_red_black_step_matches_numpy_reference(stencil, shape, dtype, tolerance):
    """The red-black collective-Jacobi step exactly as the lowering emits
    it (masked jnp half-sweeps, residual recomputed between colours)
    against the plain float64 numpy reference, on odd and ragged shapes
    and for a same-colour-coupled (9-point) stencil."""
    from evostencils_tpu.ops import reference as ref

    rng = np.random.default_rng(3)
    u = rng.standard_normal(shape)
    f = rng.standard_normal(shape)
    step = CycleLowering(dtype).lower(ref.red_black_cycle(stencil, shape, 1.15))
    got = step((jnp.asarray(u, dtype),), (jnp.asarray(f, dtype),))[0]
    assert got.dtype == dtype and got.shape == shape
    want = ref.red_black_step(np.asarray(jnp.asarray(u, dtype), np.float64),
                              np.asarray(jnp.asarray(f, dtype), np.float64),
                              1.15, stencil.entries)
    assert ref.max_relative_error(got, want) <= tolerance
