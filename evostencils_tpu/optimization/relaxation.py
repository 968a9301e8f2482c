"""Gradient-based relaxation-factor tuning of an evolved cycle.

The reference could only retune relaxation weights by patching the
generated C++'s global variables and recompiling (reference
code_generation/exastencils.py:241-293, optimization/intergrid_transfer.py).
Here the lowered cycle is *differentiable in its ω vector* (they are
traced arguments of `step(u, f, ω)` — backend/lowering.lower_parameterized),
so the asymptotic contraction can be minimized directly with Adam:

    loss(ω) = log ‖r_K(ω)‖ − log ‖r_J(ω)‖   (J < K)

i.e. the measured log-contraction over iterations J..K of the cycle
applied to the real problem — a smooth surrogate of log ρ.  One jitted
value-and-grad evaluation per step; typically converges in ~50 steps.

This is a post-evolution refinement pass: evolution finds the cycle
*structure*, gradients polish its continuous parameters on device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from evostencils_tpu.ir.transformations import collect_cycles


def tune_relaxation_factors(
    expression,
    problem,
    lowering=None,
    iterations: int = 50,
    warmup_cycles: int = 4,
    measure_cycles: Optional[int] = None,
    rho_estimate: Optional[float] = None,
    learning_rate: float = 0.05,
    omega_bounds: Tuple[float, float] = (0.1, 1.9),
    verbose: bool = False,
):
    """Return (tuned_omegas, final_loss_history) and write the tuned
    factors back into the expression's Cycle nodes.

    The ω search interval matches the grammar's relaxation-factor
    terminals (np.linspace(0.1, 1.9, 37), reference multigrid.py:428) —
    but the tuned values are continuous, a strict superset of what
    evolution alone can reach.
    """
    from evostencils_tpu.backend.lowering import CycleLowering
    from evostencils_tpu.grammar import multigrid as mg
    from evostencils_tpu.ops import stencil_ops as sops

    if lowering is None:
        lowering = CycleLowering(problem.dtype)
    if measure_cycles is None:
        measure_cycles = 5
    step, omega_values = lowering.lower_parameterized(expression)
    grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
    level = grids[0].level
    u0, f = problem.initial_state(problem.dtype, level=level)
    lo, hi = omega_bounds

    # Tune on pure error propagation: e' = C(ω)·e with f ≡ 0 and a fixed
    # random error.  After a few warmup cycles the dominant error mode
    # emerges (power iteration), the error is renormalized (no f32
    # cancellation floor — nothing is subtracted), and the measured
    # per-cycle log-contraction is a smooth, noise-free surrogate of log ρ.
    import numpy as _np

    rng = _np.random.default_rng(7)
    e0 = tuple(
        jnp.asarray(rng.standard_normal(x.shape), dtype=problem.dtype) for x in u0
    )
    zero_f = tuple(jnp.zeros_like(x) for x in f)

    def to_omegas(params):
        # smooth bounding: ω = lo + (hi-lo)·sigmoid(p)
        return lo + (hi - lo) * jax.nn.sigmoid(params)

    def from_omegas(omegas):
        t = (jnp.asarray(omegas, dtype=jnp.float32) - lo) / (hi - lo)
        t = jnp.clip(t, 1e-4, 1 - 1e-4)
        return jnp.log(t) - jnp.log1p(-t)

    @jax.jit
    def loss_fn(params):
        omegas = to_omegas(params)
        e = e0
        for _ in range(warmup_cycles):
            e = step(e, zero_f, omegas)
        norm = sops.l2_norm(e)
        eps = jnp.asarray(1e-30, dtype=jnp.real(norm).dtype)
        e = tuple(x / (norm + eps) for x in e)
        for _ in range(measure_cycles):
            e = step(e, zero_f, omegas)
        return jnp.log(jnp.real(sops.l2_norm(e)) + eps)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    params = from_omegas(omega_values)
    # Adam
    m = jnp.zeros_like(params)
    v = jnp.zeros_like(params)
    beta1, beta2, adam_eps = 0.9, 0.999, 1e-8
    best = (math.inf, params)
    history: List[float] = []
    for t in range(1, iterations + 1):
        value, grad = value_and_grad(params)
        value = float(value)
        history.append(value)
        if value < best[0] and math.isfinite(value):
            best = (value, params)
        if not jnp.all(jnp.isfinite(grad)):
            break
        m = beta1 * m + (1 - beta1) * grad
        v = beta2 * v + (1 - beta2) * grad * grad
        m_hat = m / (1 - beta1**t)
        v_hat = v / (1 - beta2**t)
        params = params - learning_rate * m_hat / (jnp.sqrt(v_hat) + adam_eps)
        if verbose and t % 10 == 0:
            print(f"tune step {t}: per-cycle log-contraction "
                  f"{value / measure_cycles:.4f}", flush=True)

    tuned = [float(w) for w in to_omegas(best[1])]
    # Write the tuned factors back into the IR (canonical slot order).
    for cycle, omega in zip(collect_cycles(expression), tuned):
        cycle.relaxation_factor = omega
    return tuned, history


def tune_outer_relaxation(
    expression,
    generator,
    iterations: int = 10,
    sigma: float = 0.12,
    omega_bounds: Tuple[float, float] = (0.1, 1.9),
    population_size: Optional[int] = None,
    seed: int = 0,
    verbose: bool = False,
):
    """CMA-ES tuning of a preconditioner cycle's ω vector against the
    measured OUTER Krylov solve (Helmholtz: preconditioned BiCGStab
    outer iterations to the 1e-7 target).

    `tune_relaxation_factors` minimizes the *inner* cycle's contraction —
    but for the shifted-Laplace preconditioner the outer iteration count
    is nearly flat in inner strength (measured: V(1,1)→V(3,3) all
    ~429-453 outer its at k=80) while the relaxation factors move it by
    ~15% (ω=0.8: 392 its).  So the right post-evolution objective is the
    outer count itself.  It is integer-valued and non-differentiable →
    derivative-free CMA-ES.  Cost stays modest because the cycle's ω are
    traced arguments of the cached outer executable
    (backend/evaluation._build_outer_solver): every CMA-ES candidate is
    a pure re-execution, no recompilation.

    The reference has no counterpart — its ω retuning patches generated
    C++ globals and recompiles per candidate (reference
    code_generation/exastencils.py:241-293).

    Returns (tuned_omegas, best_outer_iterations); the expression's
    Cycle nodes are left holding the best ω found.
    """
    import numpy as _np

    from evostencils_tpu.optimization.intergrid_transfer import CMAES

    cycles = collect_cycles(expression)
    if not cycles:
        return [], math.inf
    x0 = _np.array([float(c.relaxation_factor) for c in cycles])
    lo, hi = omega_bounds

    def set_omegas(ws):
        ws = _np.clip(ws, lo, hi)
        for c, w in zip(cycles, ws):
            c.relaxation_factor = float(w)
        return ws

    def fitness(ws):
        set_omegas(ws)
        t, _, it = generator.generate_and_evaluate(
            expression, evaluation_samples=1
        )
        if not math.isfinite(t) or t >= 1e100:
            # Failure: order capped runs by how far they got.
            return 1e6 + float(it)
        # Iterations dominate; time breaks ties between equal counts.
        return float(it) + 1e-6 * float(t)

    best_f = fitness(x0)
    best_w = x0.copy()
    if verbose:
        print(f"tune_outer start: {best_f:.2f} with ω={x0.round(3).tolist()}",
              flush=True)
    es = CMAES(x0, sigma, population_size=population_size, seed=seed)
    for g in range(iterations):
        sols = es.ask()
        fits = _np.array([fitness(w) for w in sols])
        es.tell(sols, fits)
        i = int(fits.argmin())
        if fits[i] < best_f:
            best_f = float(fits[i])
            best_w = _np.clip(sols[i], lo, hi).copy()
        if verbose:
            print(f"tune_outer gen {g}: best {best_f:.2f} "
                  f"(gen min {fits.min():.2f})", flush=True)
    tuned = set_omegas(best_w)
    return [float(w) for w in tuned], (
        best_f if best_f < 1e6 else math.inf
    )
