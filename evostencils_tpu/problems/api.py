"""Problem specification API.

Replaces the reference's ExaSlang DSL files + parser
(example_problems/*.exa2/.exa3 + code_generation/parser.py): a problem is
declared directly in Python as linear equations over named operators with
stencil generators, a level range, and a right-hand side.  Everything the
grammar needs (EquationInfo / OperatorInfo / fields) and everything the
backend needs (grids, system operator, RHS arrays) derives from here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from evostencils_tpu.grammar import multigrid as mg
from evostencils_tpu.ir import base, system


def make_grid(level: int, dimension: int) -> base.Grid:
    n = 2**level
    return base.Grid((n,) * dimension, (1.0 / n,) * dimension, level)


class Problem:
    """A PDE problem over a level hierarchy.

    operator_factories: dict name -> (stencil_generator_factory(level),
    operator_type); instantiated per level [min_level, max_level].
    equations: list of (name, "lhs == rhs") strings using operator/field names.
    rhs_functions: per-field callable f(x0, x1, ...) -> numpy array (vectorized).
    """

    def __init__(
        self,
        name: str,
        dimension: int,
        min_level: int,
        max_level: int,
        fields: Sequence[str],
        equation_strings: Sequence[Tuple[str, str]],
        operator_factories: Dict[str, Tuple[Callable, type]],
        rhs_functions: Optional[Sequence[Callable]] = None,
        dtype=jnp.float32,
        parameters: Optional[Dict] = None,
        uses_fas: bool = False,
        constants: Optional[Dict[str, float]] = None,
        outer_solver: Optional[Dict] = None,
        residual_target: float = 1e-12,
        iteration_limit: int = 500,
    ):
        self.name = name
        self.dimension = dimension
        self.min_level = min_level
        self.max_level = max_level
        self.field_names = list(fields)
        self.fields = list(fields)
        self.equation_strings = list(equation_strings)
        self.operator_factories = dict(operator_factories)
        self.rhs_functions = rhs_functions
        self.dtype = dtype
        self.parameters = dict(parameters or {})
        self.uses_fas = uses_fas
        self.constants = dict(constants or {})
        self.outer_solver = outer_solver
        self.residual_target = residual_target
        self.iteration_limit = iteration_limit
        self.coarsening_factors = [(2,) * dimension for _ in self.fields]
        self._build()

    def _build(self):
        self.equations: List[mg.EquationInfo] = []
        self.operators: List[mg.OperatorInfo] = []
        for level in range(self.min_level, self.max_level + 1):
            for eq_name, expr in self.equation_strings:
                self.equations.append(
                    mg.EquationInfo(eq_name, level, expr, self.constants)
                )
            for op_name, (factory, op_type) in self.operator_factories.items():
                self.operators.append(
                    mg.OperatorInfo(op_name, level, factory(level, self.parameters), op_type)
                )
        # Associate each equation with its field in declaration order
        # (reference parser.py:86-96 uses name conventions; we use order).
        for level in range(self.min_level, self.max_level + 1):
            eqs = [e for e in self.equations if e.level == level]
            for eq, field in zip(eqs, self.fields):
                eq.associated_field = field

    # ---- derived structures ----

    @property
    def finest_grid(self) -> List[base.Grid]:
        return [make_grid(self.max_level, self.dimension) for _ in self.fields]

    def grid_at(self, level: int) -> List[base.Grid]:
        return [make_grid(level, self.dimension) for _ in self.fields]

    def approximation(self) -> system.Approximation:
        return system.Approximation(
            "u",
            [base.Approximation(fn, g) for fn, g in zip(self.field_names, self.finest_grid)],
        )

    def rhs(self) -> system.RightHandSide:
        return system.RightHandSide(
            "f",
            [base.RightHandSide(f"{fn}_rhs", g) for fn, g in zip(self.field_names, self.finest_grid)],
        )

    def finest_operator(self) -> system.Operator:
        return mg.generate_system_operator(
            self.equations, self.operators, self.fields, self.max_level, 0, self.finest_grid
        )

    def interior_coordinates(self, level: int):
        n = 2**level
        axes = [np.arange(1, n) / n for _ in range(self.dimension)]
        return np.meshgrid(*axes, indexing="ij")

    def rhs_arrays(self, dtype, level: Optional[int] = None, host: bool = False) -> Tuple:
        mesh = self.interior_coordinates(level if level is not None else self.max_level)
        np_dtype = np.dtype(jnp.dtype(dtype))
        out = []
        for i, _ in enumerate(self.fields):
            fn = None if self.rhs_functions is None else self.rhs_functions[i]
            if fn is None:
                arr = np.zeros(mesh[0].shape, dtype=np_dtype)
            else:
                arr = np.asarray(fn(*mesh), dtype=np_dtype)
            out.append(arr if host else jnp.asarray(arr))
        return tuple(out)

    def initial_state(self, dtype, level: Optional[int] = None, host: bool = False,
                      rhs_seed: Optional[int] = None,
                      init_seed: Optional[int] = None):
        """(u0, f): zero initial guess, evaluated right-hand side.

        With a zero RHS the residual would be identically zero, so problems
        without an RHS function get a fixed pseudo-random f (seeded) —
        equivalent for convergence-factor measurement.  `host=True` keeps
        everything in numpy (for host-side float64 residual arithmetic).

        ``rhs_seed`` forces a seeded random right-hand side even when the
        problem has physical RHS functions: with a zero initial guess the
        error is -A⁻¹f, so sweeping the seed randomizes the initial error
        content — the sample-spread protocol for measured convergence
        factors (the reference's 20-sample final re-eval,
        optimization/program.py:928, re-runs the solver binary per sample).

        ``init_seed`` instead randomizes the INITIAL GUESS while keeping
        the problem's physical right-hand side.  For indefinite problems
        (Helmholtz k≥160) this is the protocol that still converges: a
        white-noise f injects full energy into the near-resonant modes and
        every outer solve stagnates (ρ_outer→1), whereas the initial
        residual f−A·u0 of a random u0 has that content *suppressed* (the
        near-null eigenvalues multiply it), so the spread reflects initial
        error without changing the attainable convergence.
        """
        grids = self.finest_grid if level is None else self.grid_at(level)
        shapes = [g.interior_shape for g in grids]
        np_dtype = np.dtype(jnp.dtype(dtype))
        if init_seed is not None:
            rng0 = np.random.default_rng(int(init_seed))
            u0 = tuple(
                rng0.standard_normal(s).astype(np_dtype) for s in shapes
            )
        else:
            u0 = tuple(np.zeros(s, dtype=np_dtype) for s in shapes)
        if rhs_seed is not None:
            rng = np.random.default_rng(rhs_seed)
            f = tuple(
                rng.standard_normal(s).astype(np_dtype) for s in shapes
            )
        elif self.rhs_functions is not None:
            f = self.rhs_arrays(dtype, level=level, host=True)
        else:
            rng = np.random.default_rng(42)
            f = tuple(
                rng.standard_normal(s).astype(np_dtype) for s in shapes
            )
        if host:
            return u0, f
        return (
            tuple(jnp.asarray(x) for x in u0),
            tuple(jnp.asarray(x) for x in f),
        )

    # ---- reconfiguration ----

    def _clone(self, **overrides) -> "Problem":
        kwargs = dict(
            name=self.name,
            dimension=self.dimension,
            min_level=self.min_level,
            max_level=self.max_level,
            fields=self.field_names,
            equation_strings=self.equation_strings,
            operator_factories=self.operator_factories,
            rhs_functions=self.rhs_functions,
            dtype=self.dtype,
            parameters=self.parameters,
            uses_fas=self.uses_fas,
            constants=self.constants,
            outer_solver=self.outer_solver,
            residual_target=self.residual_target,
            iteration_limit=self.iteration_limit,
        )
        kwargs.update(overrides)
        return type(self)(**kwargs)

    def with_levels(self, min_level: int, max_level: int) -> "Problem":
        return self._clone(min_level=min_level, max_level=max_level)

    def with_parameters(self, updates: Dict) -> "Problem":
        params = dict(self.parameters)
        params.update(updates)
        return self._clone(parameters=params)
