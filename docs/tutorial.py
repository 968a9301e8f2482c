#!/usr/bin/env python
"""Executable tutorial: evolve a 2D Poisson multigrid solver end-to-end.

The runnable companion of docs/tutorial.md — the same role the
reference's notebooks/tutorial.ipynb plays as executable documentation
(SURVEY.md §4).  Runs on CPU in a few minutes at the demo scale
μ = λ = 4, 10 generations (the reference notebook's scale).

    python docs/tutorial.py

Environment knobs: TUTORIAL_GENERATIONS (default 10), TUTORIAL_MU (4).
"""

import os
import random

# ── 1. Force the CPU backend (the tutorial needs no accelerator) ──────
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # f64: full 1e-12 targets
import jax.numpy as jnp

# ── 2. Declare the problem ────────────────────────────────────────────
# 2D finite-difference Poisson on the unit square, levels 3..5 (33²
# finest for speed; the reference default is 5..9 = 512²).  A problem
# bundles fields, operators (as stencil generators), equations, and the
# level hierarchy — the role of the reference's .exa2 + .knowledge files.
from evostencils_tpu.problems.poisson import poisson_2d

problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
print(f"problem: {problem.name}, levels {problem.min_level}..{problem.max_level}")

# The reference's own spec files load directly, too:
#   from evostencils_tpu.problems import load_problem_file
#   problem = load_problem_file(".../2D_FD_Poisson_fromL2.exa2")

# ── 3. Evaluate a textbook baseline cycle ─────────────────────────────
# The program generator lowers a cycle expression to one jitted JAX
# function and measures (time-to-convergence, ρ, iterations) — the
# replacement for the reference's java+make+run pipeline.
from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar.multigrid import generate_primitive_set
from evostencils_tpu.ir.reference_cycles import generate_v_cycle

generator = JaxProgramGenerator(problem, dtype=jnp.float64, iteration_limit=100)
_, terminal_list = generate_primitive_set(
    problem.approximation(), problem.rhs(), problem.dimension,
    problem.coarsening_factors, problem.max_level, problem.equations,
    problem.operators, problem.fields,
    depth=problem.max_level - problem.min_level,
)
baseline = generate_v_cycle(terminal_list, problem.rhs(),
                            pre_smoothing=2, post_smoothing=2)
t_ms, rho, iters = generator.generate_and_evaluate(baseline, evaluation_samples=1)
print(f"textbook V(2,2): rho={rho:.4f}, {iters} iterations to 1e-12, "
      f"{t_ms:.2f} ms modeled time-to-convergence")

# ── 4. Evolve solvers with grammar-guided genetic programming ─────────
# The optimizer owns the typed multigrid grammar, the (μ+λ)-EA loop,
# the fitness cache, checkpointing, and hall-of-fame archives.
from evostencils_tpu.optimization.optimizer import Optimizer

mu = int(os.environ.get("TUTORIAL_MU", 4))
generations = int(os.environ.get("TUTORIAL_GENERATIONS", 10))
optimizer = Optimizer.for_problem(
    problem, program_generator=generator,
    checkpoint_directory_path="/tmp/tutorial_checkpoints",
    rng=random.Random(42),
)
best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
    mu_=mu, lambda_=mu,
    population_initialization_factor=2,
    generations=generations,
    generalization_interval=10_000,     # no problem-size ramp at demo scale
    optimization_method=optimizer.SOGP,  # single-objective; NSGAII for (ρ, t)
    evaluation_samples=1,
    maximum_local_system_size=4,
    verbose=True,
)
print(f"\nbest individual ({len(hofs[-1])} in hall of fame):\n{best[:120]}...")

# ── 5. Re-evaluate the champion from its grammar string ───────────────
# Tree strings are the durable artifact (the reference stores
# individual_<j>.txt files); they re-parse through the typed grammar.
t_ms, rho, iters = optimizer.generate_and_evaluate_program_from_grammar_representation(
    best, maximum_block_size=4, evaluation_samples=3
)
print(f"champion re-evaluated: rho={rho:.4f}, {iters} iterations")
assert rho < 1.0, "evolved champion must converge"

# ── 6. Gradient-tune the relaxation factors (JAX-native extra) ────────
# Differentiates the measured log-contraction through the whole lowered
# solve w.r.t. every ω in the cycle — the reference approximated this by
# patching generated C++ globals and recompiling.
from evostencils_tpu.grammar import gp as gp_mod
from evostencils_tpu.optimization.relaxation import tune_relaxation_factors

tree = gp_mod.parse_tree(best, optimizer._pset)
expression, _ = gp_mod.compile_tree(tree, optimizer._pset)
tuned, losses = tune_relaxation_factors(expression, problem, iterations=30)
generator._solver_cache.clear()
_, rho_tuned, _ = generator.generate_and_evaluate(expression, evaluation_samples=1)
print(f"after gradient ω-tuning: rho {rho:.4f} -> {rho_tuned:.4f}")

# ── 7. Where to go from here ─────────────────────────────────────────
# * scripts/optimize.py           full CLI (NSGA-II, checkpoints, FAS,
#                                 Helmholtz k-ladder, --problem-file)
# * scripts/headline_1024.py      1024² time-to-1e-10 measurement
# * scripts/evaluate_evolved_solver.py   re-run stored hall-of-fame trees
# * docs/tutorial.md              the narrated version of this script
print("\ntutorial complete")
