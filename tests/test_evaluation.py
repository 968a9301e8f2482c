"""Evaluation-harness semantics: poisoning rules, staged f32 measurement,
caching behavior (reference fitness semantics, SURVEY §5.3/§6)."""

import jax.numpy as jnp
import numpy as np
import pytest

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir import base, partitioning as part, smoother
from evostencils_tpu.ir.reference_cycles import generate_v_22_cycle_two_grid
from evostencils_tpu.problems.poisson import poisson_2d


@pytest.fixture(scope="module")
def setup():
    problem = poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        5, problem.equations, problem.operators, problem.fields, depth=1,
        maximum_local_system_size=4,
    )
    return problem, terminals[0]


def jacobi_cycle(t0, f, omega, steps=1):
    u, A = t0.approximation, t0.operator
    for _ in range(steps):
        res = base.Residual(A, u, f)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(A)), res
        )
        u = base.Cycle(u, f, corr, partitioning=part.Single, relaxation_factor=omega)
    return u


class TestPoisoning:
    def test_divergent_gets_infinity(self, setup):
        problem, t0 = setup
        # omega = 1.9 on plain Jacobi diverges (|1-1.9·2| = 2.8 > 1)
        cycle = jacobi_cycle(t0, problem.rhs(), omega=1.9)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        # Time is poisoned, but ρ and the iteration count stay measured
        # (the cap a real run would execute) so the EA's √(ρ·iters)
        # fallback orders failures by work, not ρ alone.
        assert t >= 1e50
        assert rho > 0.9
        assert gen.iteration_limit <= iters < 1e50

    def test_slow_but_convergent_reports_rho(self, setup):
        problem, t0 = setup
        cycle = jacobi_cycle(t0, problem.rhs(), omega=0.8)
        gen = JaxProgramGenerator(problem, dtype=jnp.float64, iteration_limit=60)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        # Cap breach -> infinite time, but rho is still measured and < 1,
        # and the extrapolated iteration count is finite and beyond the cap.
        assert t >= 1e50
        assert 0.9 < rho < 1.0
        assert 60 < iters < 1e50

    def test_iteration_cap_matches_reference(self, setup):
        problem, t0 = setup
        cycle = generate_v_22_cycle_two_grid(t0, problem.rhs())
        # cap=2: even rho~0.005 needs ~5 iterations to 1e-12 -> poisoned
        gen = JaxProgramGenerator(problem, dtype=jnp.float64, iteration_limit=2)
        t, rho, iters = gen.generate_and_evaluate(cycle, evaluation_samples=1)
        assert t >= 1e50
        assert 2 < iters < 1e50


class TestStagedF32:
    def test_f32_matches_f64_within_factor(self, setup):
        problem64, t0 = setup
        cycle = generate_v_22_cycle_two_grid(t0, problem64.rhs())
        gen64 = JaxProgramGenerator(problem64, dtype=jnp.float64)
        _, rho64, it64 = gen64.generate_and_evaluate(cycle, evaluation_samples=1)

        problem32 = poisson_2d(min_level=4, max_level=5, dtype=jnp.float32)
        _, terminals32 = generate_primitive_set(
            problem32.approximation(), problem32.rhs(), 2,
            problem32.coarsening_factors, 5, problem32.equations,
            problem32.operators, problem32.fields, depth=1,
            maximum_local_system_size=4,
        )
        cycle32 = generate_v_22_cycle_two_grid(terminals32[0], problem32.rhs())
        gen32 = JaxProgramGenerator(problem32, dtype=jnp.float32)
        _, rho32, it32 = gen32.generate_and_evaluate(cycle32, evaluation_samples=1)
        assert rho32 < 1.0
        # staged measurement keeps f32 within ~3x of the f64 truth
        assert rho32 < max(3 * rho64, 0.1)
        assert it32 <= 3 * it64 + 3


class TestCaching:
    def test_structural_cache_shares_executables(self, setup):
        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        c1 = jacobi_cycle(t0, problem.rhs(), omega=0.7, steps=2)
        c2 = jacobi_cycle(t0, problem.rhs(), omega=1.2, steps=2)
        gen.generate_and_evaluate(c1, evaluation_samples=1)
        n_cached = len(gen._solver_cache)
        _, _, built = gen._build_solver(c2)
        assert built is False  # same structure, different omegas -> hit
        assert len(gen._solver_cache) == n_cached

    def test_different_structures_share_vm_interpreter(self, setup):
        """Structures inside the cycle-VM ISA share ONE interpreter
        executable — a different structure is a different *program*
        (data), not a new compile."""
        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        c1 = jacobi_cycle(t0, problem.rhs(), omega=0.7, steps=1)
        c2 = jacobi_cycle(t0, problem.rhs(), omega=0.7, steps=2)
        gen.generate_and_evaluate(c1, evaluation_samples=1)
        _, prog2, built = gen._build_solver(c2)
        assert built is False
        _, prog1, _ = gen._build_solver(c1)
        assert int(prog1[2]) != int(prog2[2])  # different program lengths

    def test_untranslatable_structure_misses(self, setup):
        """Outside the VM ISA the per-structure lowering compile-cache
        applies: a new structure is a new build."""
        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)

        def scaled_jacobi(omega, steps):
            u, A, f = t0.approximation, t0.operator, problem.rhs()
            for _ in range(steps):
                res = base.Residual(A, u, f)
                corr = base.Scaling(
                    1.0,
                    base.Multiplication(
                        base.Inverse(smoother.generate_collective_jacobi(A)), res
                    ),
                )
                u = base.Cycle(
                    u, f, corr, partitioning=part.Single, relaxation_factor=omega
                )
            return u

        c1 = scaled_jacobi(0.7, 1)
        c2 = scaled_jacobi(0.7, 2)
        vm1, prog1 = gen._vm_program(c1)
        assert prog1 is None
        assert vm1.last_failure == "not_translatable"
        gen.generate_and_evaluate(c1, evaluation_samples=1)
        _, _, built = gen._build_solver(c2)
        assert built is True

    def test_precompile_populates_cache(self, setup):
        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        exprs = [
            jacobi_cycle(t0, problem.rhs(), omega=w, steps=s)
            for w, s in ((0.5, 1), (0.9, 1), (0.5, 2))
        ]
        n = gen.precompile(exprs, max_workers=2)
        assert n == 2  # two distinct structures among the three
        for e in exprs:
            _, _, built = gen._build_solver(e)
            assert built is False


class TestBatchedGroupEvaluation:
    def test_group_matches_individual_measurements(self, setup):
        """vmapped same-structure evaluation (population batching over the
        relaxation-factor axis) must agree with one-by-one evaluation."""
        problem32 = poisson_2d(min_level=4, max_level=5, dtype=jnp.float32)
        _, terminals = generate_primitive_set(
            problem32.approximation(), problem32.rhs(), 2,
            problem32.coarsening_factors, 5, problem32.equations,
            problem32.operators, problem32.fields, depth=1,
            maximum_local_system_size=4,
        )
        t0 = terminals[0]
        f = problem32.rhs()

        def two_grid(w):
            u, A = t0.approximation, t0.operator
            for _ in range(2):
                res = base.Residual(A, u, f)
                corr = base.Multiplication(
                    base.Inverse(smoother.generate_collective_jacobi(A)), res
                )
                u = base.Cycle(u, f, corr, partitioning=part.RedBlack,
                               relaxation_factor=w)
            res = base.Residual(A, u, f)
            f_c = base.Multiplication(t0.restriction, res)
            cgc = base.Multiplication(
                base.CoarseGridSolver("CGS", t0.coarse_operator), f_c
            )
            corr = base.Multiplication(t0.prolongation, cgc)
            return base.Cycle(u, f, corr, relaxation_factor=1.0)

        exprs = [two_grid(w) for w in (0.6, 1.0, 1.4, 1.9)]
        gen = JaxProgramGenerator(problem32, dtype=jnp.float32)
        grouped = gen.generate_and_evaluate_group(exprs, evaluation_samples=1)
        gen2 = JaxProgramGenerator(problem32, dtype=jnp.float32)
        single = [
            gen2.generate_and_evaluate(e, evaluation_samples=1) for e in exprs
        ]
        for (tg, rg, ig), (ts, rs, is_) in zip(grouped, single):
            if rs >= 1e50:
                assert rg >= 1e50 or rg >= 1.0
            else:
                assert rg == pytest.approx(rs, rel=1e-5)
                assert ig == is_


class TestDeviceFaultTolerance:
    """A device-level fault (kernel fault, out of memory) must poison the
    individual's fitness, not kill the evolution run, and is counted; a run
    of consecutive faults must abort loudly (unusable device)."""

    def _failing_generator(self, setup):
        import jax

        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)

        def build(expression):
            def boom(*args, **kwargs):
                raise jax.errors.JaxRuntimeError("INTERNAL: device error")

            return (boom, boom, problem.finest_operator()), [0.8], False

        gen._build_solver = build
        return gen

    def test_single_fault_poisons_individual(self, setup):
        _, t0 = setup
        gen = self._failing_generator(setup)
        f = gen.problem.rhs()
        cycle = jacobi_cycle(t0, f, 0.8)
        t, rho, iters = gen.generate_and_evaluate(cycle, infinity=1e100)
        assert t == 1e100 and iters == 1e100
        assert gen._consecutive_device_failures == 1
        assert gen.device_failures == 1

    def test_consecutive_faults_abort(self, setup):
        _, t0 = setup
        gen = self._failing_generator(setup)
        f = gen.problem.rhs()
        cycle = jacobi_cycle(t0, f, 0.8)
        for _ in range(4):
            gen.generate_and_evaluate(cycle, infinity=1e100)
        with pytest.raises(RuntimeError, match="consecutive device"):
            gen.generate_and_evaluate(cycle, infinity=1e100)

    def test_success_resets_counter(self, setup):
        problem, t0 = setup
        gen = JaxProgramGenerator(problem, dtype=jnp.float64)
        gen._consecutive_device_failures = 3
        gen.device_failures = 3
        f = gen.problem.rhs()
        cycle = jacobi_cycle(t0, f, 0.8, steps=2)
        t, rho, iters = gen.generate_and_evaluate(cycle, infinity=1e100)
        assert gen._consecutive_device_failures == 0
        # The lifetime count never resets: a run reports every failure.
        assert gen.device_failures == 3


class TestKLadderProtocol:
    """Reference Helmholtz semantics (exastencils.py:518-535): each
    fitness evaluation sweeps k, 2k, 4k; mean on success, accumulated
    sums returned immediately on failure; base k restored."""

    def _gen(self):
        from evostencils_tpu.problems.helmholtz import helmholtz_2d

        problem = helmholtz_2d(min_level=3, max_level=5)
        return JaxProgramGenerator(problem, dtype=jnp.complex64)

    def test_ladder_success_averages(self, monkeypatch):
        gen = self._gen()
        seen = []

        def fake(expression, infinity, evaluation_samples):
            seen.append(gen.problem.parameters["k"])
            return (30.0, 0.6, 30)

        monkeypatch.setattr(gen, "_generate_and_evaluate_measured", fake)
        t, rho, it = gen.generate_and_evaluate(
            object(), global_variable_values={"k": 80.0}
        )
        assert seen == [80.0, 160.0, 320.0]
        assert (t, rho, it) == (30.0, 0.6, 30.0)
        assert gen.problem.parameters["k"] == 80.0

    def test_ladder_failure_returns_sums(self, monkeypatch):
        gen = self._gen()
        results = iter([(5.0, 0.4, 10), (1e100, 2.0, 500)])
        monkeypatch.setattr(
            gen, "_generate_and_evaluate_measured",
            lambda *a: next(results),
        )
        t, rho, it = gen.generate_and_evaluate(
            object(), global_variable_values={"k": 80.0}
        )
        assert t >= 1e100
        assert rho == pytest.approx(2.4)
        assert it == 510
        assert gen.problem.parameters["k"] == 80.0

    def test_single_rung_evolution_mode(self, monkeypatch):
        """ladder_rungs=1 (evolution economics): only the base k is
        measured, its result returned unaveraged, base k untouched."""
        from evostencils_tpu.problems.helmholtz import helmholtz_2d

        problem = helmholtz_2d(min_level=3, max_level=5)
        gen = JaxProgramGenerator(
            problem, dtype=jnp.complex64, ladder_rungs=1
        )
        seen = []

        def fake(expression, infinity, evaluation_samples):
            seen.append(gen.problem.parameters["k"])
            return (30.0, 0.6, 30)

        monkeypatch.setattr(gen, "_generate_and_evaluate_measured", fake)
        t, rho, it = gen.generate_and_evaluate(
            object(), global_variable_values={"k": 80.0}
        )
        assert seen == [80.0]
        assert (t, rho, it) == (30.0, 0.6, 30.0)
        assert gen.problem.parameters["k"] == 80.0

    def test_parameter_signature_keys_caches(self):
        gen = self._gen()
        sig80 = gen._param_sig
        gen._apply_parameter_values({"k": 160.0})
        assert gen._param_sig != sig80
        gen._apply_parameter_values({"k": 80.0})
        assert gen._param_sig == sig80


def test_power_iteration_rate_float32_matches_float64():
    """The float32 fitness measurement (error-propagation power
    iteration) against the same program in float64 — the reference the
    GPU smoke test compares with."""
    from evostencils_tpu.ir.reference_cycles import generate_v_cycle

    rates = {}
    for dtype in (jnp.float32, jnp.float64):
        problem = poisson_2d(min_level=3, max_level=5, dtype=dtype)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, 5, problem.equations,
            problem.operators, problem.fields, depth=2,
            maximum_local_system_size=4,
        )
        cycle = generate_v_cycle(tl, problem.rhs(), 2, 1)
        gen = JaxProgramGenerator(problem, dtype=dtype)
        rates[dtype] = gen.power_iteration_rate(cycle)
        if dtype == jnp.float32:
            _, rho, _ = gen.generate_and_evaluate(cycle, evaluation_samples=1)
            assert rho == rates[dtype]
    assert 0.0 < rates[jnp.float64] < 0.2
    assert rates[jnp.float32] == pytest.approx(rates[jnp.float64], rel=1e-4)
