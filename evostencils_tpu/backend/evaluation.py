"""On-device fitness evaluation: convergence factor + wall-clock harness.

This is the accelerator-native `ProgramGenerator` (duck-typed protocol the
optimizer consumes — reference optimization/program.py:110-146, implemented
by code_generation/exastencils.py:39-592 in the reference).  Instead of
java → make → subprocess, an evolved cycle expression is lowered to jitted
device functions, executed and timed with `block_until_ready`.

Fitness semantics preserved (reference exastencils.py:417-443,539-584;
program.py:386-453): ρ, time to the 1e-12 residual target, iteration
count; iteration-cap breach / NaN / divergence → infinity poisoning.

Measurement strategies per regime:
  * f32 linear cycles (the device hot path): asymptotic ρ via error-propagation
    power iteration — e ← C(ω)·e with f ≡ 0, renormalized blocks until the
    rate stabilizes.  Floor-free (nothing is subtracted) and exact
    (validated against dense spectral radii); iterations to 1e-12 follow
    as ⌈log ε / log ρ⌉ and time/iteration is measured on the real
    residual-driven solve, compiled lazily for survivors only.
  * f64 (CPU tests) and nonlinear FAS: residual-driven `lax.while_loop`
    runs with stall patience, pace-based early exit, and — for linear f64
    — host-refined float64 restarts on the error equation.
  * Helmholtz-style problems: the evolved cycle preconditions an outer
    BiCGStab run on the indefinite operator (the reference's hand-written
    driver).

Throughput machinery: structural compile cache keyed modulo relaxation
factors (ω is a traced vector argument), AOT-compiled executables,
threaded precompilation of a population's distinct structures, and
vmapped batched evaluation of same-structure individuals over the ω axis.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.backend.lowering import CycleLowering
from evostencils_tpu.stencils import periodic
from evostencils_tpu.ir import base, system
from evostencils_tpu.ir.transformations import canonical_string, collect_cycles
from evostencils_tpu.ops import stencil_ops as sops




# A power-iteration rate of exactly 0.0 is an f32 underflow of a superb
# cycle's error norm (machine-zero contraction within one measurement
# block) — clamp to a finite, best-ordered value instead of poisoning.
ZERO_RATE_CLAMP = 1e-16


def _np_dtype(dtype):
    return np.dtype(jnp.dtype(dtype))


def _dtype_is_complex(dtype) -> bool:
    return np.issubdtype(_np_dtype(dtype), np.complexfloating)


def _dtype_is_64bit(dtype) -> bool:
    """True for float64/complex128."""
    return _np_dtype(dtype) in (np.dtype(np.float64), np.dtype(np.complex128))


class EvaluationResult:
    __slots__ = (
        "time_to_convergence",
        "convergence_factor",
        "iterations",
        "time_per_iteration",
    )

    def __init__(self, time_to_convergence, convergence_factor, iterations, time_per_iteration):
        self.time_to_convergence = time_to_convergence
        self.convergence_factor = convergence_factor
        self.iterations = iterations
        self.time_per_iteration = time_per_iteration


class JaxProgramGenerator:
    """Evaluate evolved cycles fully on device.

    Implements the optimizer-facing protocol: `generate_storage`,
    `initialize_code_generation`, `generate_cycle_function`,
    `generate_and_evaluate`, `reinitialize`, `uses_FAS`, plus the extracted
    problem properties.
    """

    def __init__(
        self,
        problem,
        dtype=None,
        epsilon: Optional[float] = None,
        iteration_limit: Optional[int] = None,
        measure_reduction: Optional[float] = None,
        timing_iterations: int = 10,
        device=None,
        mesh=None,
        ladder_rungs: int = 3,
    ):
        self.problem = problem
        # Number of k-ladder rungs evaluated per Helmholtz fitness
        # (reference exastencils.py:518-535 runs 3: k, 2k, 4k).  During
        # evolution a single rung (base k only) keeps selection pressure on
        # the actual target instead of poisoning every fitness with the
        # higher rungs that even textbook cycles fail; champions are then
        # validated on the full ladder by scripts/evaluate_helmholtz_ladder.
        self.ladder_rungs = max(1, int(ladder_rungs))
        # Optional jax.sharding.Mesh: fine-grid states are sharded over the
        # "sp" axis and every solver executable runs SPMD (the product
        # surface for multi-chip evaluation, VERDICT round 2 item 4).
        self.mesh = mesh
        self.dtype = dtype if dtype is not None else problem.dtype
        self.epsilon = (
            epsilon if epsilon is not None else getattr(problem, "residual_target", 1e-12)
        )
        self.iteration_limit = (
            iteration_limit
            if iteration_limit is not None
            else getattr(problem, "iteration_limit", 500)
        )
        if measure_reduction is None:
            # f64 (CPU tests with jax_enable_x64) runs the full target in
            # one stage.  f32 measures in per-stage windows of 1e-4 — three
            # restarted stages compound to the 1e-12 reference target while
            # each window stays well above the f32 residual floor (whose
            # tail would otherwise dilute the measured contraction).
            is_f64 = _dtype_is_64bit(self.dtype)
            measure_reduction = self.epsilon if is_f64 else max(self.epsilon, 1e-4)
        self.measure_reduction = measure_reduction
        self.timing_iterations = timing_iterations
        self.device = device
        self.lowering = CycleLowering(self.dtype, mesh=mesh)
        self._solver_cache = {}
        self._vms = {}
        self._power_fns = {}
        self._vmapped_cache = {}
        self._timer_cache = {}
        self.run_time_total = 0.0
        self.compile_time_total = 0.0
        # Optional RHS seed for sample-spread re-measurement: when set,
        # initial states use a seeded random right-hand side (randomized
        # initial error content; see Problem.initial_state).  The solver
        # cache is unaffected — only the runtime arguments change.
        self.rhs_seed = None
        # Optional INITIAL-GUESS seed (the convergent spread protocol for
        # indefinite problems — Problem.initial_state docstring).  On the
        # outer-Krylov path the randomness enters host-side via the error
        # equation (x_total=u0, rhs=f−A·u0); device stage guesses stay zero.
        self.init_seed = None
        self._level_offset = 0
        self._consecutive_device_failures = 0
        # Every device-level failure of this generator's lifetime (never
        # reset): a healthy run reports 0 (utils/profiling.evaluation_report).
        self.device_failures = 0
        # Cycle-VM observability: how many solver builds took the
        # compile-free interpreter path vs per-structure lowering, and why
        # the VM was skipped (translation miss vs program-pad overflow).
        self.vm_hits = 0
        self.vm_misses = 0
        self.vm_pad_overflows = 0
        self.vm_isa_recompiles = 0

    @property
    def _param_sig(self):
        """Hashable PDE-parameter signature: compiled executables are
        cached per parameter value, so a k-ladder revisiting the same k
        for every individual reuses its solvers (the reference instead
        recompiled the generated C++ per k, exastencils.py:269-288)."""
        return tuple(sorted(
            (k, v) for k, v in self.problem.parameters.items()
            if isinstance(v, (int, float, complex))
        ))

    def _structural_key(self, expression, prefix: str = "solve"):
        return (
            prefix,
            self._param_sig,
            canonical_string(expression, parameterize_relaxation=True),
        )

    def _apply_parameter_values(self, values) -> bool:
        """Switch the problem's PDE parameters; caches stay (keyed by
        signature)."""
        changed = any(
            self.problem.parameters.get(k) != v for k, v in values.items()
        )
        if changed:
            self.problem = self.problem.with_parameters(values)
        return changed

    def vm_stats(self) -> dict:
        total = self.vm_hits + self.vm_misses
        return {
            "vm_hits": self.vm_hits,
            "vm_misses": self.vm_misses,
            "vm_pad_overflows": self.vm_pad_overflows,
            "vm_isa_recompiles": self.vm_isa_recompiles,
            "vm_hit_rate": (self.vm_hits / total) if total else None,
        }

    def _device_failed(self):
        """Account one device-level failure (a kernel fault or an
        out-of-memory error).  A lone faulting individual is poisoned with
        infinity fitness and evolution continues; a *run* of failures means
        the device itself is unusable — re-raise so the evolution run
        aborts loudly instead of silently returning infinity for everyone."""
        self.device_failures += 1
        self._consecutive_device_failures += 1
        if self._consecutive_device_failures >= 5:
            raise RuntimeError(
                f"{self._consecutive_device_failures} consecutive device "
                "failures — the accelerator appears unusable"
            ) from None

    def _initial_state_for(self, expression, use_init_seed=True):
        """(u0, f) device arrays at the expression's level.

        ``use_init_seed=False`` keeps u0 zero even when ``self.init_seed``
        is set — the outer-Krylov path needs zero device stage guesses
        (each stage solves an error equation) and applies the seeded
        initial guess host-side instead."""
        return self.problem.initial_state(
            self.dtype, level=self._expression_level(expression),
            rhs_seed=self.rhs_seed,
            init_seed=self.init_seed if use_init_seed else None,
        )

    def _error_probe(self, u0):
        """(e0, zf): the power iteration's seeded random error and zero
        right-hand side, shaped like the state ``u0``."""
        rng = np.random.default_rng(self._probe_error_seed())
        np_dtype = _np_dtype(self.dtype)
        e0 = tuple(
            jnp.asarray(rng.standard_normal(x.shape).astype(np_dtype))
            for x in u0
        )
        zf = tuple(jnp.zeros(x.shape, dtype=self.dtype) for x in u0)
        return e0, zf

    # ---- problem properties (protocol surface) ----

    @property
    def dimension(self):
        return self.problem.dimension

    @property
    def finest_grid(self):
        return self.problem.finest_grid

    @property
    def coarsening_factor(self):
        return self.problem.coarsening_factors

    @property
    def min_level(self):
        return self.problem.min_level

    @property
    def max_level(self):
        return self.problem.max_level

    @property
    def equations(self):
        return self.problem.equations

    @property
    def operators(self):
        return self.problem.operators

    @property
    def fields(self):
        return self.problem.fields

    def uses_FAS(self):
        return getattr(self.problem, "uses_fas", False)

    # ---- protocol no-ops (no external workspaces / files needed) ----

    def generate_storage(self, min_level, max_level, finest_grid):
        return []

    def initialize_code_generation(self, min_level, max_level, iteration_limit=None):
        if iteration_limit is not None:
            self.iteration_limit = iteration_limit

    def reinitialize(self, min_level, max_level, level_offset=0):
        """Generalization ramp: shift the level range (problem-size ramp)."""
        self._level_offset = level_offset
        self.problem = self.problem.with_levels(min_level, max_level)
        self._solver_cache.clear()
        self._vms.clear()
        self._power_fns.clear()
        self._vmapped_cache.clear()
        self._timer_cache.clear()

    def generate_cycle_function(self, expression, storages=None, min_level=None,
                                max_level=None, use_global_weights=False):
        """The durable program representation: the canonical IR string."""
        return canonical_string(expression)

    # ---- core evaluation ----

    def _expression_level(self, expression) -> int:
        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        return grids[0].level

    def _mesh_wrap(self, step):
        """Pin the step's state to the ("sp", None, …) sharding so every
        stencil sum partitions over the mesh (XLA inserts the halo
        collective-permutes; see parallel/mesh.py).  Identity without a
        mesh."""
        if self.mesh is None:
            return step
        from evostencils_tpu.parallel import mesh as pmesh

        mesh = self.mesh

        def wrapped(u, f, omegas):
            u = pmesh.shard_state(u, mesh)
            f = pmesh.shard_state(f, mesh)
            return pmesh.shard_state(step(u, f, omegas), mesh)

        return wrapped

    def _as_omega_arg(self, omega_values):
        """Device-ready omega argument: a VM program triple passes through
        verbatim, a relaxation-factor list becomes the traced f32 vector."""
        if isinstance(omega_values, tuple):
            return omega_values
        return jnp.asarray(omega_values, dtype=jnp.float32)

    def _finest_operator_for(self, expression):
        # The run's finest level is the expression's own grid level (it may
        # sit below problem.max_level during multi-run level splitting).
        from evostencils_tpu.grammar import multigrid as mg

        level = self._expression_level(expression)
        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        return mg.generate_system_operator(
            self.problem.equations, self.problem.operators, self.problem.fields,
            level, 0, grids,
        )

    def _build_solver(self, expression):
        """Structural compile cache: the key abstracts over relaxation
        factors (they enter as a traced vector argument), so mutations
        that only retune ω reuse the same XLA executable — the
        structural-interpreter strategy replacing the reference's
        per-individual java+make pipeline (SURVEY.md §7.4).

        When the expression is expressible in the cycle VM's ISA (the
        linear multigrid grammar — backend/vm.py), the structure itself
        becomes a traced argument and ALL such individuals share one
        interpreter executable: zero per-structure compiles."""
        vm, program = self._vm_program(expression)
        if program is not None:
            self.vm_hits += 1
            return self._build_vm_solver(vm, program, expression)
        self.vm_misses += 1
        if vm is not None and getattr(vm, "last_failure", None) == "pad_overflow":
            self.vm_pad_overflows += 1
        key = self._structural_key(expression)
        omega_values = [
            float(c.relaxation_factor) for c in collect_cycles(expression)
        ]
        if key in self._solver_cache:
            return self._solver_cache[key], omega_values, False
        step = self._mesh_wrap(self.lowering.lower_parameterized(expression)[0])
        operator = self._finest_operator_for(expression)
        stage_raw, power_raw = self._stage_power_fns(step, operator)

        stage = jax.jit(stage_raw)
        power = jax.jit(power_raw)

        # Eager-compile only what fitness needs first: for f32 linear
        # cycles that is the power iteration (it decides poisoning); the
        # residual stage is then compiled lazily, and only for survivors
        # that reach the timing phase.  Nonlinear/f64 paths need the stage
        # eagerly.
        is_f64 = _dtype_is_64bit(self.dtype)
        linear = not getattr(self.problem, "uses_fas", False)
        # f64 keeps the (lazily jitted) power iteration for
        # power_iteration_rate; fitness there uses the staged solve.
        power_compiled = power if linear else None
        if linear and not is_f64:
            power_compiled = self._aot_compile_power(power, expression, len(omega_values))
            stage_handle = stage  # lazy: jax.jit compiles on first call
            self._power_fns[key] = power
        else:
            stage_handle = self._aot_compile(stage, expression, len(omega_values))
        self._solver_cache[key] = (stage_handle, power_compiled, operator)
        return (stage_handle, power_compiled, operator), omega_values, True

    def _stage_power_fns(self, step, operator):
        """The two measurement programs around a cycle step function
        step(u, f, omega_arg): the residual-driven staged solve and the
        error-propagation power iteration.  `omega_arg` is opaque — the
        ω vector for lowered structures, the (opcodes, ω, length) program
        triple for the cycle VM."""
        lowering = self.lowering

        cap = self.iteration_limit
        target = self.measure_reduction
        # Pace-based early exit: an individual must reach the 1e-12 target
        # within `iteration_limit` iterations to survive poisoning, i.e.
        # sustain ρ ≤ ε^(1/cap).  Once it falls 10× behind that pace, no
        # mild transient can save it — stop burning device time on it.
        rho_required = self.epsilon ** (1.0 / cap)
        grace = 10.0

        def residual_norm(u, f):
            return sops.l2_norm(
                sops.tree_sub(f, lowering.system_apply(operator, u))
            )

        # Stall patience: in f32 the attainable residual floor
        # (ε_machine·‖A‖·‖u‖) can sit above the measure target; once the
        # residual stops improving for `patience` iterations we are at the
        # floor and the best point so far defines this stage's reduction.
        patience = 5

        def stage_raw(u0, rhs, omegas):
            res0 = residual_norm(u0, rhs)
            zero = jnp.asarray(0, dtype=jnp.int32)

            def cond(carry):
                _, res, it, best_res, best_it, _ = carry
                ok = res > target * res0
                not_diverged = res < 1e8 * res0
                not_stalled = (it - best_it) < patience
                on_pace = jnp.logical_or(
                    it < 25,
                    res < grace * res0 * rho_required ** it.astype(res.dtype),
                )
                return jnp.logical_and(
                    jnp.logical_and(it < cap, ok),
                    jnp.logical_and(
                        jnp.logical_and(not_diverged, jnp.isfinite(res)),
                        jnp.logical_and(on_pace, not_stalled),
                    ),
                )

            def body(carry):
                u, _, it, best_res, best_it, best_u = carry
                u = step(u, rhs, omegas)
                res = residual_norm(u, rhs)
                it = it + 1
                improved = res < best_res
                best_it = jnp.where(improved, it, best_it)
                best_u = tuple(
                    jnp.where(improved, x, bx) for x, bx in zip(u, best_u)
                )
                best_res = jnp.where(improved, res, best_res)
                return u, res, it, best_res, best_it, best_u

            _, _, executed_it, best_res, best_it, best_u = jax.lax.while_loop(
                cond, body, (u0, res0, zero, res0, zero, u0)
            )
            return best_res, res0, best_it, best_u, executed_it

        # Asymptotic ρ via error-propagation power iteration (linear
        # cycles): e ← C(ω)·e with f ≡ 0, renormalized every block — no
        # subtraction, hence no f32 cancellation floor.  Blocks run until
        # the per-cycle rate stabilizes (the textbook power method on the
        # iteration operator).  Residual-based runs systematically
        # over-estimate ρ of fast solvers in f32 because their short
        # stages are transient-dominated; this measurement matches the
        # reference's long f64 runs (validated against exact dense
        # spectral radii in tests).
        block_len = 10

        def power_raw(e0, zf, omegas):
            def one_block(e):
                # Renormalize EVERY cycle, accumulating log-norms: a block
                # rate of ρ^block_len underflows f32 for very fast cycles
                # (ρ ≲ 1e-4 → ‖e‖ < 1e-38 after 10 cycles), which used to
                # read as machine-zero contraction (ZERO_RATE_CLAMP) and
                # report ρ = 1e-16 for genuinely-finite champions.
                def body(_, carry):
                    e, log_acc = carry
                    e = step(e, zf, omegas)
                    n = jnp.real(sops.l2_norm(e))
                    safe = jnp.where(n > 0, n, 1.0)
                    e = tuple(x / safe for x in e)
                    # Dtype-aware floor: an exactly-zero norm contributes
                    # log(tiny) (a huge negative rate → ZERO_RATE_CLAMP
                    # downstream) instead of -inf.
                    floor = jnp.finfo(n.dtype).tiny
                    log_acc = log_acc + jnp.log(jnp.where(n > 0, n, floor))
                    return e, log_acc

                # Accumulator dtype follows the norm dtype so the carry
                # stays consistent if the power path ever runs at 64-bit.
                norm_dtype = jnp.real(sops.l2_norm(e)).dtype
                zero = jnp.asarray(0.0, norm_dtype)
                e, log_acc = jax.lax.fori_loop(0, block_len, body, (e, zero))
                rate = jnp.exp(log_acc / block_len)
                return e, rate

            def cond(carry):
                _, prev_rate, rate, k = carry
                unconverged = jnp.abs(rate - prev_rate) > 0.02 * jnp.abs(rate)
                not_diverged = jnp.logical_and(rate < 2.0, jnp.isfinite(rate))
                return jnp.logical_and(
                    jnp.logical_and(k < 8, jnp.logical_or(k < 3, unconverged)),
                    not_diverged,
                )

            def body(carry):
                e, prev_rate, rate, k = carry
                e, new_rate = one_block(e)
                return e, rate, new_rate, k + 1

            e, rate0 = one_block(e0)
            _, _, rate, k = jax.lax.while_loop(
                cond,
                body,
                (e, jnp.asarray(0.0, rate0.dtype), rate0, jnp.asarray(1, jnp.int32)),
            )
            return rate, k * block_len

        return stage_raw, power_raw

    # ---- cycle-VM fast path (backend/vm.py) ----

    def _vm_for(self, level: int):
        vm_key = (self._param_sig, level)
        vm = self._vms.get(vm_key)
        if vm is None:
            from evostencils_tpu.backend.vm import CycleVM

            # Outer-Krylov problems use the slim ISA: the interpreter body
            # is inlined twice per BiCGStab iteration, so the full ISA's
            # graph compiles much more slowly; block-smoother individuals
            # fall back to per-structure lowering instead.
            slim = getattr(self.problem, "outer_solver", None) is not None
            vm = CycleVM(self.lowering, self.problem, level,
                         include_block_smoothers=not slim)
            self._vms[vm_key] = vm
        return vm

    def _vm_program(self, expression):
        """(vm, Program) when the expression is expressible in the VM ISA.
        On translation failure returns (vm, None) with `vm.last_failure`
        set; (None, None) when the VM doesn't apply at all (FAS, single
        level) — either way the per-structure lowering path applies."""
        if getattr(self.problem, "uses_fas", False):
            return None, None
        level = self._expression_level(expression)
        if level - self.problem.min_level + 1 < 2:
            return None, None
        vm = self._vm_for(level)
        program = vm.translate(expression)
        if program is None:
            # vm is returned so the caller can read vm.last_failure.
            return vm, None
        return vm, program

    def _build_vm_solver(self, vm, program, expression):
        """One interpreter executable per (level, ISA version) — every
        translatable structure shares it; the program rides the omega
        argument slot as a (opcodes, omegas, length) triple."""
        omega_arg = program.as_arguments()
        level = self._expression_level(expression)
        # The pad class is part of the executable's shape contract: a
        # pad-64 compiled interpreter cannot ingest a pad-160 program.
        key = ("__vm__", self._param_sig, level, vm.isa_version,
               int(program.opcodes.shape[0]))
        if key in self._solver_cache:
            return self._solver_cache[key], omega_arg, False
        if any(
            isinstance(k, tuple) and k[:3] == ("__vm__", self._param_sig, level)
            for k in self._solver_cache
        ):
            # A previous ISA version was already compiled for this level —
            # a lazily-registered op (novel transfer stencil / Krylov CGS)
            # is forcing a full interpreter recompile.
            self.vm_isa_recompiles += 1
        step = self._mesh_wrap(vm.make_step())
        operator = self._finest_operator_for(expression)
        stage_raw, power_raw = self._stage_power_fns(step, operator)
        stage = jax.jit(stage_raw)
        power = jax.jit(power_raw)
        if not _dtype_is_64bit(self.dtype):
            # Registered for the batched ω-group path: same-structure
            # individuals vmap over the program's ω slice in ONE dispatch.
            self._power_fns[key] = power
        self._solver_cache[key] = (stage, power, operator)
        return (stage, power, operator), omega_arg, True

    def _power_probe_state(self, expression):
        """(u0, f, e0, zf) probe states at the expression's level: the
        shared initial state, the seeded random error and the zero
        right-hand side.  Single source of truth for the AOT-compiled
        argument shapes of the vmapped/group power paths."""
        u0, f = self._initial_state_for(expression)
        e0, zf = self._error_probe(u0)
        return u0, f, e0, zf

    def _probe_error_seed(self):
        """Seed for the power-iteration error probe.  Default rng(7); when
        ``rhs_seed`` or ``init_seed`` is set (sample-spread re-measurement,
        scripts/champion_stats.py) the probe error is reseeded too, so the
        n-sample ρ spread on the f32/power path reflects distinct initial
        error content rather than n identical measurements."""
        seed = 7
        if self.rhs_seed is not None:
            seed += int(self.rhs_seed)
        if self.init_seed is not None:
            seed += 1009 * int(self.init_seed)
        return seed

    def power_iteration_rate(self, expression) -> float:
        """Asymptotic convergence factor of a linear cycle by the
        error-propagation power iteration at the generator's dtype — the
        float32 fitness measurement, and at float64 its reference."""
        (_, power, _), omega_values, _ = self._build_solver(expression)
        if power is None:
            raise ValueError("no power iteration for nonlinear (FAS) cycles")
        u0, _ = self._initial_state_for(expression)
        e0, zf = self._error_probe(u0)
        rate, _ = power(e0, zf, self._as_omega_arg(omega_values))
        return float(jnp.real(rate))

    def _vmapped_power(self, key, expression, bucket: int, n_omegas: int,
                       program_extras=None):
        """vmap the power iteration over a batch of relaxation-factor
        vectors: same-structure individuals (the dominant offspring class —
        ω-retuning mutations) evaluate in ONE device dispatch.  Bucketed
        batch sizes bound the number of compilations per structure.

        With `program_extras` = (opcodes, length) the omega argument is the
        cycle-VM program triple; the batch axis rides its ω slice only."""
        cache_key = (key, bucket)
        if cache_key in self._vmapped_cache:
            return self._vmapped_cache[cache_key]
        power = self._power_fns[key]
        omega_axes = (None, 0, None) if program_extras is not None else 0
        vmapped = jax.jit(jax.vmap(power, in_axes=(None, None, omega_axes)))
        _, _, e0, zf = self._power_probe_state(expression)
        omegas = jnp.zeros((bucket, n_omegas), dtype=jnp.float32)
        if program_extras is not None:
            opcodes, length = program_extras
            omegas = (jnp.asarray(opcodes), omegas,
                      jnp.asarray(length, dtype=jnp.int32))
        compiled = vmapped.lower(e0, zf, omegas).compile()
        self._vmapped_cache[cache_key] = compiled
        return compiled

    def generate_and_evaluate_group(
        self, expressions, infinity=1e100, evaluation_samples=3,
        global_variable_values=None,
    ):
        """Batched evaluation of same-structure individuals.

        All expressions must share the ω-parameterized structural key; ρ is
        computed for the whole group by one vmapped power-iteration
        dispatch, and time/iteration — identical across the group (same
        executable) — is measured once on the first surviving member.
        Returns a list of (time_to_convergence, ρ, iterations) triples.
        """
        if global_variable_values:
            self._apply_parameter_values(global_variable_values)
        if getattr(self.problem, "outer_solver", None) or getattr(
            self.problem, "uses_fas", False
        ):
            return [
                self.generate_and_evaluate(
                    e, infinity=infinity, evaluation_samples=evaluation_samples,
                    global_variable_values=global_variable_values,
                )
                for e in expressions
            ]
        try:
            (stage_solve, power_compiled, operator), omega_arg0, _ = (
                self._build_solver(expressions[0])
            )
            vm_mode = isinstance(omega_arg0, tuple)
            if vm_mode:
                level = self._expression_level(expressions[0])
                vm_obj = self._vm_for(level)
                key = ("__vm__", self._param_sig, level, vm_obj.isa_version,
                       int(np.asarray(omega_arg0[0]).shape[0]))
            else:
                key = self._structural_key(expressions[0])
            if power_compiled is None or key not in self._power_fns:
                raise RuntimeError("no batched path")
            if vm_mode:
                # Same-structure programs share opcodes; the batch axis is
                # the ω slice of the program triple.
                opc0 = np.asarray(omega_arg0[0])
                omegas_rows = []
                for e in expressions:
                    _, prog = self._vm_program(e)
                    if prog is None or not np.array_equal(prog.opcodes, opc0):
                        raise RuntimeError("no batched path")
                    omegas_rows.append(prog.omegas)
            else:
                omegas_rows = [
                    [float(c.relaxation_factor) for c in collect_cycles(e)]
                    for e in expressions
                ]
            n = len(expressions)
            bucket = 2
            while bucket < n:
                bucket *= 2
            bucket = min(bucket, 16)
            if n > bucket:
                # larger than the biggest bucket: split recursively
                return self.generate_and_evaluate_group(
                    expressions[:bucket], infinity, evaluation_samples
                ) + self.generate_and_evaluate_group(
                    expressions[bucket:], infinity, evaluation_samples
                )
            mat = np.tile(np.asarray(omegas_rows[0], dtype=np.float32), (bucket, 1))
            for i, row in enumerate(omegas_rows):
                mat[i, :] = row
            vm = self._vmapped_power(
                key, expressions[0], bucket, mat.shape[1],
                program_extras=(omega_arg0[0], omega_arg0[2]) if vm_mode else None,
            )
            u0, f, e0, zf = self._power_probe_state(expressions[0])
            if vm_mode:
                batch_omegas = (
                    jnp.asarray(omega_arg0[0]), jnp.asarray(mat),
                    jnp.asarray(omega_arg0[2], dtype=jnp.int32),
                )
            else:
                batch_omegas = jnp.asarray(mat)
            rates, _ = jax.block_until_ready(vm(e0, zf, batch_omegas))
            rates = np.asarray(jnp.real(rates))[:n]
            self._consecutive_device_failures = 0
        except (RuntimeError, ValueError, TypeError, NotImplementedError,
                FloatingPointError):
            return [
                self.generate_and_evaluate(
                    e, infinity=infinity, evaluation_samples=evaluation_samples,
                    global_variable_values=global_variable_values,
                )
                for e in expressions
            ]

        results = []
        t_iter_ms = None
        for i, rate in enumerate(rates):
            rate = float(rate)
            if rate == 0.0:
                # f32 underflow of a superb cycle's power-iterate norm —
                # machine-zero contraction, the best possible outcome, not
                # an invalid measurement.
                rate = ZERO_RATE_CLAMP
            if not math.isfinite(rate) or rate < 0.0:
                results.append((infinity, infinity, infinity))
                continue
            if rate >= 1.0:
                # Non-contractive: a real run would execute the full
                # iteration cap — report it as the measured count so the
                # EA's √(ρ·iters) fallback stays finite and informative
                # (reference parse_output measures the executed count,
                # exastencils.py:539-584).
                results.append((infinity, rate, self.iteration_limit))
                continue
            iterations = int(math.ceil(math.log(self.epsilon) / math.log(rate)))
            if iterations > self.iteration_limit:
                results.append((infinity, rate, iterations))
                continue
            if t_iter_ms is None:
                try:
                    omegas_i = jnp.asarray(omegas_rows[i], dtype=jnp.float32)
                    if vm_mode:
                        omegas_i = (
                            jnp.asarray(omega_arg0[0]), omegas_i,
                            jnp.asarray(omega_arg0[2], dtype=jnp.int32),
                        )
                    _, _, _, _, executed = jax.block_until_ready(
                        stage_solve(u0, f, omegas_i)
                    )
                    executed = max(1, int(executed))
                    times = []
                    for _ in range(max(1, evaluation_samples)):
                        t0 = time.perf_counter()
                        jax.block_until_ready(stage_solve(u0, f, omegas_i))
                        times.append(time.perf_counter() - t0)
                    times.sort()
                    t_iter_ms = 1e3 * times[len(times) // 2] / executed
                    self.run_time_total += sum(times)
                except jax.errors.JaxRuntimeError:
                    self._device_failed()
                    results.append((infinity, rate, iterations))
                    continue
            results.append((iterations * t_iter_ms, rate, iterations))
        return results

    def _aot_compile_power(self, power, expression, n_omegas):
        _, _, e0, zf = self._power_probe_state(expression)
        omegas = jnp.zeros((n_omegas,), dtype=jnp.float32)
        return power.lower(e0, zf, omegas).compile()

    def _host_residual(self, operator, u_fields, f_fields):
        """Exact float64 residual computed on host.

        At an f32 stall the *device* residual is dominated by rounding
        noise; the true residual — evaluated in f64 numpy — is the honest
        right-hand side for the next measurement stage (restarted
        error-equation measurement; see generate_and_evaluate)."""
        out = []
        for i, row in enumerate(operator.entries):
            acc = np.asarray(f_fields[i], dtype=np.complex128 if
                             np.iscomplexobj(f_fields[i]) else np.float64).copy()
            for entry, u in zip(row, u_fields):
                u64 = np.asarray(u, dtype=acc.dtype)
                gen = getattr(entry, "stencil_generator", None)
                if isinstance(entry, base.ZeroOperator):
                    continue
                if gen is not None and getattr(gen, "is_nonlinear", False):
                    raise NotImplementedError("host residual: nonlinear")
                if gen is not None and getattr(gen, "is_variable", lambda: False)():
                    offsets, planes = gen.generate_coefficient_arrays(entry.grid)
                    reach = tuple(
                        max(abs(o[a]) for o in offsets) for a in range(len(offsets[0]))
                    )
                    padded = np.pad(u64, [(r, r) for r in reach])
                    for offset, plane in zip(offsets, planes):
                        index = tuple(
                            slice(r + o, r + o + n)
                            for r, o, n in zip(reach, offset, u64.shape)
                        )
                        acc -= np.asarray(plane, dtype=acc.dtype) * padded[index]
                    continue
                stencil = entry.generate_stencil()
                if isinstance(stencil, periodic.PeriodicStencil):
                    if not stencil.is_uniform():
                        raise NotImplementedError("host residual: periodic entry")
                    stencil = stencil.as_constant()
                acc -= sops.numpy_apply_constant_stencil(u64, stencil)
            out.append(acc)
        return out

    def _aot_compile(self, solve, expression, n_omegas):
        """Ahead-of-time compile for the run's input shapes: the cached
        object is the XLA executable itself, so cache hits skip tracing
        entirely (the analog of reusing a built solver binary)."""
        u0, f = self._initial_state_for(expression)
        omegas = jnp.zeros((n_omegas,), dtype=jnp.float32)
        return solve.lower(u0, f, omegas).compile()

    def precompile(self, expressions, max_workers: int = 8):
        """Trace+compile distinct cycle structures concurrently.

        XLA compilation is the per-individual cost that remains (the analog
        of the reference's java+make, reference exastencils.py:381-415);
        it runs on host threads, so a population's distinct structures
        pipeline across a thread pool while the device stays busy
        executing already-compiled individuals.
        """
        import concurrent.futures
        import threading

        distinct = {}
        outer = getattr(self.problem, "outer_solver", None) is not None
        for expression in expressions:
            key = self._structural_key(expression, "outer" if outer else "solve")
            if key not in self._solver_cache:
                distinct.setdefault(key, expression)
        if not distinct:
            return 0

        # Tracing deep unrolled cycles recurses heavily; default worker
        # thread stacks can overflow (SIGSTKFLT kills the process without a
        # traceback).  Give pool threads a generous stack.
        previous_stack = threading.stack_size()
        try:
            threading.stack_size(64 * 1024 * 1024)
        except (ValueError, RuntimeError):
            previous_stack = None

        def build(expression):
            # _build_solver AOT-compiles and inserts into the shared cache;
            # failures are left for the evaluation call to poison.
            try:
                if getattr(self.problem, "outer_solver", None):
                    self._build_outer_solver(expression)
                else:
                    self._build_solver(expression)
            except Exception:
                pass
            return None

        try:
            with concurrent.futures.ThreadPoolExecutor(max_workers) as pool:
                list(pool.map(build, distinct.values()))
        finally:
            if previous_stack is not None:
                try:
                    threading.stack_size(previous_stack)
                except (ValueError, RuntimeError):
                    pass
        return len(distinct)

    def _outer_operator_for(self, expression):
        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        level = self._expression_level(expression)
        spec = self.problem.outer_solver
        outer_entry = base.Operator(
            "A_outer", grids[0], spec["operator_factory"](level, self.problem.parameters)
        )
        return system.Operator("A_outer", [[outer_entry]])

    def _outer_solve_raw(self, step, outer_operator, max_iterations):
        from evostencils_tpu.ops import krylov

        lowering = self.lowering
        spec = self.problem.outer_solver
        target = spec["target_reduction"]
        if not _dtype_is_64bit(self.dtype):
            # Per-STAGE device target: in f32/complex64 the on-device
            # residual recurrence floors near 1e-6-1e-7 relative (term
            # cancellation at the operator's 1/h² scale), so each device
            # stage solves to 1e-6 and _generate_and_evaluate_outer
            # restarts from the exact host-f64 residual until the spec's
            # true target (the reference's 1e-7) is met — stage
            # reductions compound, so the full target is reached in f32.
            target = max(target, 1e-6)

        def apply_a(state):
            return lowering.system_apply(outer_operator, state)

        def solve_raw(u0, f, omegas):
            def apply_m(state):
                zeros = tuple(jnp.zeros_like(x) for x in state)
                return step(zeros, state, omegas)

            x, it, res = krylov.preconditioned_bicgstab(
                apply_a, apply_m, f, max_iterations, target
            )
            res0 = sops.l2_norm(f)
            return x, jnp.real(res), jnp.real(res0), it

        return solve_raw

    def _build_outer_solver(self, expression, probe_iterations=None):
        """Helmholtz-style evaluation: the evolved cycle preconditions a
        BiCGStab run on the outer operator (reference exa3
        PreconditionedBiCGStab + exastencils.py:518-535 ladder protocol).

        When the inner cycle is expressible in the cycle-VM ISA
        (backend/vm.py), the whole outer solve — BiCGStab + interpreted
        preconditioner — compiles ONCE per (parameters, level, cap) and
        every individual rides it as data: Helmholtz evolution pays zero
        per-structure compiles, the economics fix VERDICT round 2 asked
        for.  `probe_iterations` builds a short-capped variant (the
        prescreen stage)."""
        tag = "outer" if probe_iterations is None else f"outer_probe_{probe_iterations}"
        spec = self.problem.outer_solver
        max_iterations = (
            spec["max_iterations"] if probe_iterations is None else probe_iterations
        )
        level = self._expression_level(expression)

        vm, program = self._vm_program(expression)
        if program is not None:
            if probe_iterations is None:
                self.vm_hits += 1
            omega_arg = program.as_arguments()
            key = ("__vm__", self._param_sig, level, vm.isa_version, tag,
                   program.opcodes.shape[0])
            if key in self._solver_cache:
                return self._solver_cache[key], omega_arg, False
            outer_operator = self._outer_operator_for(expression)
            solve = jax.jit(
                self._outer_solve_raw(
                    self._mesh_wrap(vm.make_step()), outer_operator,
                    max_iterations,
                )
            )
            self._solver_cache[key] = (solve, outer_operator)
            return (solve, outer_operator), omega_arg, True

        if probe_iterations is None:
            self.vm_misses += 1
            if vm is not None and getattr(vm, "last_failure", None) == "pad_overflow":
                self.vm_pad_overflows += 1
        key = self._structural_key(expression, tag)
        omega_values = [float(c.relaxation_factor) for c in collect_cycles(expression)]
        if key in self._solver_cache:
            return self._solver_cache[key], omega_values, False
        step = self._mesh_wrap(self.lowering.lower_parameterized(expression)[0])
        outer_operator = self._outer_operator_for(expression)
        solve = jax.jit(
            self._outer_solve_raw(step, outer_operator, max_iterations)
        )
        compiled = self._aot_compile(solve, expression, len(omega_values))
        self._solver_cache[key] = (compiled, outer_operator)
        return (compiled, outer_operator), omega_values, True

    def generate_and_evaluate(
        self,
        expression,
        storages=None,
        min_level=None,
        max_level=None,
        solver_program=None,
        infinity=1e100,
        evaluation_samples=3,
        global_variable_values=None,
    ):
        """Returns (time_to_convergence_ms, convergence_factor, iterations)."""
        if global_variable_values:
            self._apply_parameter_values(global_variable_values)
            if "k" in global_variable_values and getattr(
                self.problem, "outer_solver", None
            ):
                # The reference's Helmholtz protocol evaluates every
                # individual across a k-ladder: k, 2k, 4k, averaging the
                # three measurements (reference exastencils.py:518-535).
                return self._evaluate_k_ladder(
                    expression, infinity, evaluation_samples
                )
        return self._generate_and_evaluate_measured(
            expression, infinity, evaluation_samples
        )

    def _evaluate_k_ladder(self, expression, infinity, evaluation_samples):
        """k, 2k, 4k ladder with the reference's exact combination rule:
        arithmetic mean over the three steps; on any failure, return the
        accumulated sums immediately (reference exastencils.py:518-535 —
        failure sums keep failures ordered worse than successes)."""
        base_k = self.problem.parameters["k"]
        rungs = self.ladder_rungs
        total_t = total_rho = total_it = 0.0
        try:
            for i in range(rungs):
                t, rho, it = self._generate_and_evaluate_measured(
                    expression, infinity, evaluation_samples
                )
                total_t += t
                total_rho += rho
                total_it += it
                if not math.isfinite(t) or t >= infinity or rho > 1:
                    return total_t, total_rho, total_it
                if i < rungs - 1:
                    self._apply_parameter_values(
                        {"k": self.problem.parameters["k"] * 2.0}
                    )
        finally:
            self._apply_parameter_values({"k": base_k})
        return total_t / rungs, total_rho / rungs, total_it / rungs

    def _generate_and_evaluate_measured(
        self, expression, infinity, evaluation_samples
    ):
        if getattr(self.problem, "outer_solver", None):
            return self._generate_and_evaluate_outer(
                expression, infinity, evaluation_samples
            )
        try:
            t0 = time.perf_counter()
            (stage_solve, power_solve, operator), omega_values, newly_compiled = (
                self._build_solver(expression)
            )
            u0, f = self._initial_state_for(expression)
            omegas = self._as_omega_arg(omega_values)

            is_f64 = _dtype_is_64bit(self.dtype)
            if power_solve is not None and not is_f64:
                # f32 linear cycles: asymptotic ρ via power iteration on
                # the error-propagation operator (floor-free, exact); the
                # same executable measures time per cycle (each iteration
                # includes a residual-norm computation, matching the real
                # solve's per-iteration work).
                e0, zf = self._error_probe(u0)
                rate, _ = jax.block_until_ready(power_solve(e0, zf, omegas))
                rate = float(jnp.real(rate))
                self._consecutive_device_failures = 0
                if newly_compiled:
                    self.compile_time_total += time.perf_counter() - t0
                if rate == 0.0:
                    # Machine-zero contraction (see group path): clamp so
                    # the log-based iteration count stays defined.
                    rate = ZERO_RATE_CLAMP
                if not math.isfinite(rate) or rate < 0.0:
                    return infinity, infinity, infinity
                rho = rate
                if rho >= 1.0:
                    # Measured-count semantics for failures: a real solve
                    # would stop at the iteration cap (reference
                    # exastencils.py:539-584 reports the executed count).
                    return infinity, rho, self.iteration_limit
                iterations = int(math.ceil(math.log(self.epsilon) / math.log(rho)))
                if iterations > self.iteration_limit:
                    return infinity, rho, iterations
                # Timing via the real residual-driven solve (the stage is
                # compiled lazily — only survivors pay for it).
                _, _, _, _, stage_executed = jax.block_until_ready(
                    stage_solve(u0, f, omegas)
                )
                stage1_executed = max(1, int(stage_executed))
                times = []
                for _ in range(max(1, evaluation_samples)):
                    t0 = time.perf_counter()
                    jax.block_until_ready(stage_solve(u0, f, omegas))
                    times.append(time.perf_counter() - t0)
                times.sort()
                t_iter_ms = 1e3 * times[len(times) // 2] / stage1_executed
                self.run_time_total += sum(times)
                return iterations * t_iter_ms, rho, iterations

            # Restarted measurement: when a stage stalls at the f32
            # residual floor before reaching the 1e-12 target, the *exact*
            # residual (float64 on host) becomes the next stage's
            # right-hand side — the error equation A·e = r — so stage
            # reductions multiply and f32 resolves the full reference
            # target.  Stages that exit for any other reason (target hit,
            # iteration cap, divergence, off pace) end the measurement.
            log_eps = math.log(self.epsilon)
            log_reduction = 0.0
            it = 0
            executed = 0
            rhs = f
            patience = 5
            stage1_executed = 1
            linear = not getattr(self.problem, "uses_fas", False)
            for stage_index in range(3):
                best_res, res0, best_it, best_u, stage_executed = (
                    jax.block_until_ready(stage_solve(u0, rhs, omegas))
                )
                best_it = int(best_it)
                stage_executed = int(stage_executed)
                self._consecutive_device_failures = 0
                executed += stage_executed
                if stage_index == 0:
                    stage1_executed = max(1, stage_executed)
                res0 = float(jnp.real(res0))
                best_res = float(jnp.real(best_res))
                if best_it == 0 or res0 <= 0.0 or not math.isfinite(best_res):
                    break
                ratio = best_res / res0
                if ratio >= 1.0:
                    break
                log_reduction += math.log(max(ratio, 1e-300))
                it += best_it
                stalled = (stage_executed - best_it) >= patience
                target_hit = best_res <= self.measure_reduction * res0
                # Continue only from clean exits (floor stall or stage
                # target); pace/cap/divergence exits end the measurement.
                if (
                    not linear
                    or log_reduction <= log_eps
                    or not (stalled or target_hit)
                ):
                    break
                try:
                    r64 = self._host_residual(
                        operator, self._to_host(best_u), self._to_host(rhs)
                    )
                except NotImplementedError:
                    break
                rhs = self._host_state_to_args(r64)
            if newly_compiled:
                self.compile_time_total += time.perf_counter() - t0
        except jax.errors.JaxRuntimeError:
            self._device_failed()
            return infinity, infinity, infinity
        except (RuntimeError, ValueError, NotImplementedError, FloatingPointError):
            return infinity, infinity, infinity

        executed = max(1, executed)
        if it == 0 or not math.isfinite(log_reduction):
            return infinity, infinity, infinity
        rho = math.exp(log_reduction / it)
        if not math.isfinite(rho):
            return infinity, infinity, infinity
        if rho >= 1.0:
            return infinity, rho, self.iteration_limit

        # Iterations to the reference 1e-12 target from the measured ρ
        # (exact when the run reached the target: ρ = red^(1/n) inverts to
        # exactly n; extrapolated when f32 stalls short of it).
        iterations = int(math.ceil(math.log(self.epsilon) / math.log(rho)))
        if iterations > self.iteration_limit:
            # Iteration-cap breach → time poisoned to ∞, but ρ and the
            # extrapolated count stay measured so the EA's √(ρ·iters)
            # fallback orders failures by work, not ρ alone (reference
            # exastencils.py:582-583 + program.py:413-415).
            return infinity, rho, iterations

        # Timing: median over samples of the full solve loop (residual
        # computation per iteration included — matching the reference's
        # generated solvers, which print the residual every iteration).
        times = []
        try:
            for _ in range(max(1, evaluation_samples)):
                t0 = time.perf_counter()
                jax.block_until_ready(stage_solve(u0, f, omegas))
                times.append(time.perf_counter() - t0)
        except jax.errors.JaxRuntimeError:
            self._device_failed()
            return infinity, rho, iterations
        times.sort()
        # Normalize by the executed iterations of the timed (first) stage —
        # t/iter is a property of one cycle application.
        t_iter_ms = 1e3 * times[len(times) // 2] / stage1_executed
        self.run_time_total += sum(times)
        time_to_convergence = iterations * t_iter_ms
        return time_to_convergence, rho, iterations

    def _host_state_to_args(self, host_state):
        """Host numpy state -> jit arguments at the solver dtype."""
        np_dtype = _np_dtype(self.dtype)
        return tuple(np.asarray(x).astype(np_dtype) for x in host_state)

    def _to_host(self, state):
        """Device state -> host numpy at the accumulation dtype
        (complex128/float64)."""
        np_acc = np.complex128 if _dtype_is_complex(self.dtype) else np.float64
        return tuple(np.asarray(x, np_acc) for x in state)

    def _generate_and_evaluate_outer(self, expression, infinity, evaluation_samples):
        """Outer-Krylov evaluation with host-f64 restarts.

        The device runs preconditioned BiCGStab stages to the
        f32-reachable stage target (1e-6); between stages the exact
        residual — complex128/float64 on host — becomes the next
        right-hand side (error equation), so stage reductions compound to
        the spec's TRUE target: the reference's 1e-7
        (2D_FD_Helmholtz_fromL3.exa3) is met in f32 arithmetic.
        ρ = overall contraction^(1/total iterations); the timed first
        stage extrapolates to the executed total."""
        try:
            t0 = time.perf_counter()
            u0_args, _ = self._initial_state_for(expression, use_init_seed=False)
            spec = self.problem.outer_solver
            true_target = spec["target_reduction"]
            max_iterations = spec["max_iterations"]

            is_complex = _dtype_is_complex(self.dtype)
            np_acc = np.complex128 if is_complex else np.float64
            u0_host, f_host = self.problem.initial_state(
                self.dtype, level=self._expression_level(expression), host=True,
                rhs_seed=self.rhs_seed,
            )
            f64 = tuple(np.asarray(x, np_acc) for x in f_host)
            res0_true = math.sqrt(
                sum(float(np.sum(np.abs(x) ** 2)) for x in f64)
            )
            if res0_true <= 0.0:
                return infinity, infinity, infinity

            # Short-horizon prescreen: run a probe-capped outer solve and
            # project its contraction rate to the true target.  A hopeless
            # preconditioner dies after `probe` iterations (~ms) instead of
            # the full 10000-cap stages (~minutes), and never builds the
            # full-cap solver at all — the round-3 economics fix for
            # Helmholtz evolution.  The projected count keeps failures
            # ordered (informative √(ρ·iters) fallback upstream).
            probe_seed = None
            probe = self.problem.outer_solver.get("probe_iterations", 128)
            if (
                probe
                and self.init_seed is None
                and max_iterations > 4 * probe
                and self._vm_program(expression)[1] is not None
            ):
                # VM-translatable only: the probe executable is shared by
                # the whole population there.  A per-structure probe would
                # cost an extra compile — more than the capped full
                # solve it tries to save.
                (probe_solve, probe_operator), probe_omegas, _ = (
                    self._build_outer_solver(
                        expression, probe_iterations=probe
                    )
                )
                p_x, p_res, p_res0, p_it = jax.block_until_ready(
                    probe_solve(u0_args, self._host_state_to_args(f64),
                                self._as_omega_arg(probe_omegas))
                )
                p_it = int(p_it)
                p_res = float(jnp.real(p_res))
                p_res0 = float(jnp.real(p_res0))
                self._consecutive_device_failures = 0
                if p_it == 0 or not math.isfinite(p_res) or p_res0 <= 0.0:
                    return infinity, infinity, infinity
                # p_res == 0.0 exactly is machine-zero convergence — the
                # best possible probe outcome, never a kill.
                if p_it >= probe and p_res > 0.0:
                    # did not converge within the probe cap
                    p_rate = (p_res / p_res0) ** (1.0 / p_it)
                    if p_rate >= 1.0:
                        return infinity, p_rate, max_iterations
                    projected = math.log(true_target) / math.log(p_rate)
                    # 2× slack: BiCGStab is non-monotone, a slow probe can
                    # still accelerate — only kill clearly-infeasible runs.
                    if projected > 2.0 * max_iterations:
                        return infinity, p_rate, int(min(projected, 10 * max_iterations))
                if p_res < p_res0:
                    # The survivor's probe iterations are real work — seed
                    # the staged solve with the probe solution instead of
                    # discarding up-to-`probe` outer iterations.
                    probe_seed = (self._to_host(p_x),
                                  probe_operator, p_it)

            (solve, outer_operator), omega_values, newly_compiled = (
                self._build_outer_solver(expression)
            )
            omegas = self._as_omega_arg(omega_values)

            x_total = tuple(np.zeros(np.asarray(x).shape, np_acc) for x in u0_host)
            rhs_host = f64
            total_it = 0
            it1 = None
            rel = 1.0
            if probe_seed is not None:
                x_probe, probe_operator, p_it_seed = probe_seed
                r_probe = self._host_residual(probe_operator, x_probe, f64)
                seeded_rel = math.sqrt(
                    sum(float(np.sum(np.abs(x) ** 2)) for x in r_probe)
                ) / res0_true
                if math.isfinite(seeded_rel) and seeded_rel < rel:
                    x_total = x_probe
                    rhs_host = r_probe
                    total_it = p_it_seed
                    rel = seeded_rel

            if self.init_seed is not None:
                # Seeded-initial-guess protocol: solve A·x = f from a
                # random x0 by running the staged machinery on the error
                # equation A·e = f − A·x0 (device stage guesses remain
                # zero).  Near-null modes of x0 are suppressed in the
                # initial residual, so — unlike a random RHS — the solve
                # still converges on indefinite problems.
                rng0 = np.random.default_rng(int(self.init_seed))
                x_rand = tuple(
                    rng0.standard_normal(np.asarray(x).shape).astype(np_acc)
                    for x in u0_host
                )
                r0 = tuple(self._host_residual(outer_operator, x_rand, f64))
                res0_init = math.sqrt(
                    sum(float(np.sum(np.abs(x) ** 2)) for x in r0)
                )
                if res0_init > 0.0 and math.isfinite(res0_init):
                    x_total = x_rand
                    rhs_host = r0
                    res0_true = res0_init
                    total_it = 0
                    rel = 1.0

            for _stage in range(4):
                if rel <= true_target:
                    break
                rhs_args = self._host_state_to_args(rhs_host)
                x_dev, res, res0s, it = jax.block_until_ready(
                    solve(u0_args, rhs_args, omegas)
                )
                it = int(it)
                res = float(jnp.real(res))
                res0s = float(jnp.real(res0s))
                self._consecutive_device_failures = 0
                if newly_compiled and it1 is None:
                    self.compile_time_total += time.perf_counter() - t0
                if it == 0 or not math.isfinite(res) or res0s <= 0.0:
                    return infinity, infinity, infinity
                if it1 is None:
                    it1 = it
                    # Device-measured contraction of the first stage's own
                    # recurrence: stays informative for diverged runs
                    # (res/res0 > 1 varies across individuals), unlike the
                    # host rel which clamps at 1 — preserves selection
                    # pressure among failures (the reference's measured
                    # per-iteration convergence factors do the same,
                    # exastencils.py:539-584).
                    stage1_rho = (
                        (res / res0s) ** (1.0 / it) if res > 0.0 else infinity
                    )
                total_it += it
                x_host = self._to_host(x_dev)
                x_total = tuple(a + b for a, b in zip(x_total, x_host))
                r_host = self._host_residual(outer_operator, x_total, f64)
                new_rel = math.sqrt(
                    sum(float(np.sum(np.abs(x) ** 2)) for x in r_host)
                ) / res0_true
                if new_rel <= true_target:
                    rel = new_rel
                    break
                if total_it >= max_iterations or new_rel >= rel:
                    # Cap breach or restart no longer improves: report the
                    # stage-1 measured contraction (host rel clamps at 1
                    # for diverged runs and would flatten all failures to
                    # the same fitness).
                    rel = min(rel, new_rel)
                    rho = max(rel ** (1.0 / total_it), stage1_rho)
                    return infinity, rho if math.isfinite(rho) else infinity, total_it
                rel = new_rel
                rhs_host = r_host
        except jax.errors.JaxRuntimeError:
            self._device_failed()
            return infinity, infinity, infinity
        except (RuntimeError, ValueError, NotImplementedError, FloatingPointError):
            return infinity, infinity, infinity

        if rel > true_target:
            rho = rel ** (1.0 / max(total_it, 1))
            return infinity, rho, total_it
        rho = rel ** (1.0 / total_it)
        if it1 is None:
            # The probe seed alone met the target — no staged solve ran;
            # the timing sample below solves to the same target itself, so
            # extrapolation factor is 1.
            it1 = total_it
        # Timing: median over samples of the first stage, extrapolated to
        # the executed total (per-iteration cost is stage-invariant).
        f_args = self._host_state_to_args(f64)
        times = []
        try:
            for _ in range(max(1, evaluation_samples)):
                t0 = time.perf_counter()
                jax.block_until_ready(solve(u0_args, f_args, omegas))
                times.append(time.perf_counter() - t0)
        except jax.errors.JaxRuntimeError:
            self._device_failed()
            return infinity, rho, total_it
        times.sort()
        time_to_convergence = (
            1e3 * times[len(times) // 2] * (total_it / max(it1, 1))
        )
        self.run_time_total += sum(times)
        return time_to_convergence, rho, total_it

    def evaluate_objectives(self, expression, evaluation_samples=3, infinity=1e100):
        """(ρ, time_per_iteration_ms) — the NSGA-II objective pair."""
        t, rho, iters = self.generate_and_evaluate(
            expression, infinity=infinity, evaluation_samples=evaluation_samples
        )
        if not math.isfinite(t) or t >= infinity:
            return rho, infinity
        return rho, t / iters
