"""IR → JAX compiler: lowers an evolved multigrid cycle to a jittable step.

This module is the JAX replacement for the reference's entire
code-generation backend (reference code_generation/exastencils.py:684-925
emitted ExaSlang L3, ran the Java ExaStencils compiler and g++, and executed
the binary).  Here the recursive IR walk *is* the program: each node maps to
fused JAX array ops, the result is a pure function
`step(u_fields, f_fields) -> u_fields'` that XLA compiles once per distinct
cycle structure.

Semantics preserved from the reference:
  * Cycle(u, f, corr, partitioning, ω): u' = u + ω·corr for Single;
    for RedBlack two masked half-sweeps with the residual recomputed
    against the updated iterate between colors — matching the two-sweep
    LFA symbol (reference model_based_prediction/convergence.py:76-110).
  * Inverse(B)·r dispatch: Diagonal → per-field point Jacobi,
    ElementwiseDiagonal → per-point n_fields×n_fields solve,
    block-diagonal system.Operator → batched local dense solves,
    D + Jacobian → FAS Newton smoothing.
  * CoarseGridSolver: precomputed dense inverse (matmul) or a Krylov
    method / nested evolved cycle when an expression is attached.

All constant precomputation (dense inverses, coefficient planes, masks)
happens once at lowering time and is cached across individuals by the
structural fingerprint of the operator — the analog of the reference's
per-rank workspace reuse, minus the subprocesses.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from evostencils_tpu.ir import base, system
from evostencils_tpu.ir import partitioning as part
from evostencils_tpu.ir.krylov import KrylovSubspaceMethod
from evostencils_tpu.ir.transformations import canonical_string
from evostencils_tpu.ops import coarse_solve, intergrid, krylov, smoothers
from evostencils_tpu.ops import stencil_ops as sops
from evostencils_tpu.stencils import periodic


def _is_partitioning(p, kind) -> bool:
    return p is kind or isinstance(p, kind)


class NonlinearStencilGenerator:
    """Protocol marker for operators whose stencil depends on the iterate.

    Implementations provide `apply(u, field) -> field` (the nonlinear
    operator action) and `apply_derivative_diag(u, field)` (action of the
    diagonal of the Jacobian dA/du, used by FAS Newton smoothing).
    Concrete instances live in problems/fas.py.
    """

    is_nonlinear = True


class CycleLowering:
    def __init__(self, dtype=jnp.float32, mesh=None):
        self.dtype = dtype
        # Under a device mesh every stencil sum is a pad+shift expression
        # visible to XLA's SPMD partitioner, which inserts the halo
        # exchanges itself (parallel/mesh.py).
        self.mesh = mesh
        self._dense_specs = {}
        self._block_specs = {}
        self._plane_cache = {}
        self._center_inv_cache = {}

    # ------------------------------------------------------------------
    # Operator application helpers
    # ------------------------------------------------------------------

    def _coefficient_planes(self, operator: base.Operator):
        gen = operator.stencil_generator
        grid = operator.grid
        # Content key, not object identity: Problem.grid_at builds fresh
        # Grid objects per individual (identity keys never re-hit and grow
        # without bound), and a bare id(gen) can alias a recycled address
        # after GC (see ir/transformations.py) — the cached strong
        # reference to `gen` pins its id for the cache's lifetime.
        key = (id(gen), grid.level, grid.size, grid.spacing)
        if key not in self._plane_cache:
            offsets, planes = gen.generate_coefficient_arrays(grid)
            np_dtype = np.dtype(jnp.dtype(self.dtype))
            self._plane_cache[key] = (
                gen,
                offsets,
                [np.asarray(p, dtype=np_dtype) for p in planes],
            )
        _, offsets, planes = self._plane_cache[key]
        return offsets, planes

    def entry_apply(self, entry, field):
        """Apply one scalar block entry of a system operator to a field."""
        if isinstance(entry, base.ZeroOperator):
            return jnp.zeros_like(field)
        if isinstance(entry, base.Identity):
            return field
        gen = getattr(entry, "stencil_generator", None)
        if gen is not None and getattr(gen, "is_nonlinear", False):
            raise RuntimeError(
                "Nonlinear entries must be applied through system_apply with the iterate"
            )
        if (
            isinstance(entry, base.Operator)
            and gen is not None
            and getattr(gen, "is_variable", lambda: False)()
        ):
            offsets, planes = self._coefficient_planes(entry)
            return sops.apply_variable_stencil(field, offsets, planes)
        stencil = entry.generate_stencil()
        if stencil is None:
            raise RuntimeError(f"Entry {entry!r} has no stencil")
        return sops.apply_stencil(field, stencil)

    def system_apply(self, operator: system.Operator, state: Sequence) -> Tuple:
        out = []
        for row in operator.entries:
            acc = None
            for entry, field in zip(row, state):
                gen = getattr(entry, "stencil_generator", None)
                if gen is not None and getattr(gen, "is_nonlinear", False):
                    term = gen.apply(field, entry.grid)
                elif isinstance(entry, base.ZeroOperator):
                    continue
                else:
                    term = self.entry_apply(entry, field)
                acc = term if acc is None else acc + term
            out.append(acc if acc is not None else jnp.zeros_like(state[0]))
        return tuple(out)

    @staticmethod
    def _nonlinear_entries(operator: system.Operator):
        """Diagonal (i==i) nonlinear generators, or None if fully linear."""
        gens = []
        any_nonlinear = False
        for i, row in enumerate(operator.entries):
            gen = getattr(row[i], "stencil_generator", None)
            if gen is not None and getattr(gen, "is_nonlinear", False):
                any_nonlinear = True
                gens.append((gen, row[i].grid))
            else:
                gens.append(None)
        return gens if any_nonlinear else None

    def _coarsening_factors(self, fine_grid, coarse_grid):
        return tuple(f // c for f, c in zip(fine_grid.size, coarse_grid.size))

    def intergrid_apply(self, igop, state: Sequence) -> Tuple:
        out = []
        for i, row in enumerate(igop.entries):
            entry = row[i]
            stencil = entry.generate_stencil()
            if isinstance(stencil, periodic.PeriodicStencil):
                stencil = stencil.as_constant()
            cf = self._coarsening_factors(entry.fine_grid, entry.coarse_grid)
            if isinstance(entry, base.Restriction):
                out.append(
                    intergrid.restrict(
                        state[i], stencil, entry.coarse_grid.interior_shape, cf
                    )
                )
            elif isinstance(entry, base.Prolongation):
                out.append(
                    intergrid.prolong(
                        state[i], stencil, entry.fine_grid.interior_shape, cf
                    )
                )
            else:
                raise RuntimeError(f"Not an intergrid entry: {entry!r}")
        return tuple(out)

    # ------------------------------------------------------------------
    # Smoothers: Inverse(B) · r
    # ------------------------------------------------------------------

    def _center_values(self, operator: system.Operator):
        """(n,n) matrix (or per-point planes) of center coefficients."""
        n = len(operator.entries)
        variable = False
        for row in operator.entries:
            for entry in row:
                gen = getattr(entry, "stencil_generator", None)
                if gen is not None and getattr(gen, "is_variable", lambda: False)():
                    variable = True
        if not variable:
            mat = np.zeros((n, n), dtype=np.complex128)
            for i, row in enumerate(operator.entries):
                for j, entry in enumerate(row):
                    stencil = entry.generate_stencil()
                    if stencil is None:
                        continue
                    if isinstance(stencil, periodic.PeriodicStencil):
                        stencil = stencil.as_constant()
                    mat[i, j] = stencil.center_value()
            return mat, None
        # Variable: build per-point (..., n, n) matrices in numpy.
        shape = operator.entries[0][0].grid.interior_shape
        mats = np.zeros(shape + (n, n), dtype=np.complex128)
        for i, row in enumerate(operator.entries):
            for j, entry in enumerate(row):
                gen = getattr(entry, "stencil_generator", None)
                if gen is not None and getattr(gen, "is_variable", lambda: False)():
                    offsets, planes = gen.generate_coefficient_arrays(entry.grid)
                    for o, p in zip(offsets, planes):
                        if all(x == 0 for x in o):
                            mats[..., i, j] += p
                else:
                    stencil = entry.generate_stencil()
                    if stencil is None:
                        continue
                    if isinstance(stencil, periodic.PeriodicStencil):
                        stencil = stencil.as_constant()
                    mats[..., i, j] += stencil.center_value()
        return None, mats

    def _elementwise_diagonal_inverse(self, operator: system.Operator):
        key = ("ed", canonical_string(operator))
        if key in self._center_inv_cache:
            return self._center_inv_cache[key]
        mat, mats = self._center_values(operator)
        if mats is None:
            inv = np.linalg.inv(mat)
            if not np.iscomplexobj(np.zeros((), dtype=self.dtype)):
                inv = np.real(inv)
            result = ("const", inv)
        else:
            inv = np.linalg.inv(mats)
            if not np.iscomplexobj(np.zeros((), dtype=self.dtype)):
                inv = np.real(inv)
            n = inv.shape[-1]
            np_dtype = np.dtype(jnp.dtype(self.dtype))
            planes = [
                [
                    np.asarray(inv[..., i, j], dtype=np_dtype)
                    if np.any(inv[..., i, j])
                    else None
                    for j in range(n)
                ]
                for i in range(n)
            ]
            result = ("planes", planes)
        self._center_inv_cache[key] = result
        return result

    def _diagonal_inverses(self, operator: system.Operator):
        invs = []
        for i, row in enumerate(operator.entries):
            entry = row[i]
            gen = getattr(entry, "stencil_generator", None)
            if gen is not None and getattr(gen, "is_variable", lambda: False)():
                offsets, planes = gen.generate_coefficient_arrays(entry.grid)
                center = None
                for o, p in zip(offsets, planes):
                    if all(x == 0 for x in o):
                        center = p
                invs.append(
                    np.asarray(1.0 / center, dtype=np.dtype(jnp.dtype(self.dtype)))
                )
            else:
                stencil = entry.generate_stencil()
                if isinstance(stencil, periodic.PeriodicStencil):
                    stencil = stencil.as_constant()
                invs.append(1.0 / stencil.center_value())
        return invs

    def _block_solve_spec(self, operator: system.Operator):
        key = canonical_string(operator)
        if key not in self._block_specs:
            entries = [
                [entry.generate_stencil() for entry in row] for row in operator.entries
            ]
            interior = operator.entries[0][0].grid.interior_shape
            self._block_specs[key] = smoothers.build_block_solve_spec(
                entries,
                [periodic.lift(entries[i][i]).period for i in range(len(entries))],
                interior,
                self.dtype,
            )
        return self._block_specs[key]

    def smoother_apply(self, smoothing_operator, r_state: Sequence, u_state=None) -> Tuple:
        """Apply B^{-1} to the residual state for a smoothing operator B.

        `u_state` (the current iterate) is required for the nonlinear FAS
        smoothers whose local Jacobian depends on u.
        """
        B = smoothing_operator
        if isinstance(B, system.Diagonal):
            return smoothers.decoupled_jacobi_apply(
                r_state, self._diagonal_inverses(B.operand)
            )
        if isinstance(B, system.ElementwiseDiagonal):
            nonlinear = self._nonlinear_entries(B.operand)
            if nonlinear is not None:
                return self._nonlinear_point_solve(
                    nonlinear, r_state, u_state, newton_steps=None
                )
            kind, data = self._elementwise_diagonal_inverse(B.operand)
            if kind == "const":
                return smoothers.collective_jacobi_apply(r_state, data)
            return smoothers.collective_jacobi_apply_variable(r_state, data)
        if isinstance(B, system.Operator):
            return self._block_solve_spec(B).apply(r_state)
        if isinstance(B, base.Addition) and isinstance(B.operand2, system.Jacobian):
            # FAS Newton smoother: D + J with n inner Newton steps on the
            # point-local nonlinear equation (reference
            # exastencils_FAS.py:196-252 emits the symbolic Jacobian
            # denominator; here the derivative comes from the problem's
            # nonlinear stencil generator).
            jacobian = B.operand2
            operator = jacobian.operand
            nonlinear = self._nonlinear_entries(operator)
            if nonlinear is None:
                # Linear operator: Newton degenerates to collective Jacobi.
                return self.smoother_apply(
                    system.ElementwiseDiagonal(operator), r_state, u_state
                )
            return self._nonlinear_point_solve(
                nonlinear, r_state, u_state, newton_steps=jacobian.n_newton_steps
            )
        raise RuntimeError(f"Cannot apply smoother {B!r}")

    def _nonlinear_point_solve(self, gens, r_state, u_state, newton_steps):
        """Point-local solve of L_c·δ + N(u+δ) − N(u) = r per field.

        Picard (newton_steps None): δ = r / (L_c + N'(u)) with the
        nonlinearity frozen; Newton: n damped Newton iterations of the
        scalar local equation, n=1 reducing to the same formula.
        """
        if u_state is None:
            raise RuntimeError("Nonlinear smoothing requires the current iterate")
        out = []
        for (entry, r, u) in zip(gens, r_state, u_state):
            if entry is None:
                out.append(r)
                continue
            gen, grid = entry
            center = gen.linear_center(grid)
            if newton_steps is None:
                delta = r / (center + gen.derivative_diag(u))
            else:
                n_u = gen.nonlinear_term(u)
                delta = jnp.zeros_like(r)
                for _ in range(int(newton_steps)):
                    residual_loc = r - center * delta - (
                        gen.nonlinear_term(u + delta) - n_u
                    )
                    delta = delta + residual_loc / (
                        center + gen.derivative_diag(u + delta)
                    )
            out.append(delta)
        return tuple(out)

    # ------------------------------------------------------------------
    # Coarse-grid solver
    # ------------------------------------------------------------------

    def _dense_spec(self, operator: system.Operator):
        key = canonical_string(operator)
        if key not in self._dense_specs:
            entry_matrices = []
            field_shapes = [g.interior_shape for g in operator.grid]
            for row in operator.entries:
                mats = []
                for entry in row:
                    if isinstance(entry, base.ZeroOperator):
                        mats.append(None)
                        continue
                    gen = getattr(entry, "stencil_generator", None)
                    if gen is not None and getattr(gen, "is_variable", lambda: False)():
                        planes = gen.generate_coefficient_arrays(entry.grid)
                        mats.append(
                            coarse_solve.assemble_scalar_matrix(
                                None, entry.grid.interior_shape, planes=planes
                            )
                        )
                    else:
                        mats.append(
                            coarse_solve.assemble_scalar_matrix(
                                entry.generate_stencil(), entry.grid.interior_shape
                            )
                        )
                entry_matrices.append(mats)
            self._dense_specs[key] = coarse_solve.build_dense_solve_spec(
                entry_matrices, field_shapes, self.dtype
            )
        return self._dense_specs[key]

    def cgs_apply(
        self, solver: base.CoarseGridSolver, r_state: Sequence,
        rhs_expr=None, ev=None,
    ) -> Tuple:
        expr = solver.expression
        nonlinear = self._nonlinear_entries(solver.operator)
        if nonlinear is not None:
            # Nonlinear coarse solve: fixed damped Newton–Jacobi sweeps
            # (the reference's FAS CGS@coarsest runs 200 smoother sweeps —
            # FAS_2D_Basic_template.exa4 Function CGS).  Crucially, FAS
            # requires the solve to start from the restricted solution
            # (the reference stores R·u in its Approximation field,
            # exastencils_FAS.py:121-136): the τ-corrected right-hand side
            # has the form R·r + A_c(R·u), and starting from zero would
            # leave an O(coarse-solve-error) bias that stalls the cycle at
            # a wrong fixed point.  Extract R·u structurally from the rhs.
            operator = solver.operator
            u0 = None
            if rhs_expr is not None and ev is not None and isinstance(rhs_expr, base.Addition):
                for candidate in (rhs_expr.operand2, rhs_expr.operand1):
                    if (
                        isinstance(candidate, base.Multiplication)
                        and isinstance(candidate.operand1, system.Operator)
                        and self._nonlinear_entries(candidate.operand1) is not None
                    ):
                        u0 = ev(candidate.operand2)
                        break
            if u0 is None:
                u0 = tuple(jnp.zeros_like(r) for r in r_state)

            def body(_, u):
                r = sops.tree_sub(tuple(r_state), self.system_apply(operator, u))
                corr = self._nonlinear_point_solve(nonlinear, r, u, newton_steps=None)
                return tuple(x + 0.8 * c for x, c in zip(u, corr))

            import jax

            return jax.lax.fori_loop(0, 200, body, tuple(u0))
        if expr is None:
            return self._dense_spec(solver.operator).apply(r_state)
        if isinstance(expr, KrylovSubspaceMethod):
            apply_a = partial(self.system_apply, expr.operator)
            return krylov.SOLVERS[expr.name](apply_a, tuple(r_state), expr.number_of_iterations)
        if hasattr(expr, "apply_as_solver"):
            # Nested evolved cycle from a previous optimization run
            # (multi-run level splitting): run it once on (0, r).
            return expr.apply_as_solver(self, tuple(r_state))
        raise RuntimeError(f"Unsupported coarse-grid solver expression {expr!r}")

    # ------------------------------------------------------------------
    # Main recursive evaluation
    # ------------------------------------------------------------------

    def lower(self, expression: base.Expression) -> Callable:
        """Build step(u_fields, f_fields) -> new u_fields for one cycle.

        Leaf resolution is type-based: the (unique) non-zero
        system.Approximation leaf binds to `u`, the system.RightHandSide
        leaf binds to `f`, ZeroApproximations evaluate to zeros.
        """
        multiref = self._multiref_ids(expression)

        def step(u: Tuple, f: Tuple) -> Tuple:
            memo = {}

            def ev(node):
                key = id(node)
                if key in memo:
                    return memo[key]
                value = self._eval(node, ev, u, f, None, multiref)
                memo[key] = value
                return value

            return ev(expression)

        return step

    def lower_parameterized(self, expression: base.Expression):
        """Build step(u, f, omegas) with relaxation factors as a traced
        vector argument.

        Individuals that share cycle *structure* but differ in relaxation
        factors (the most common mutation: swapping an rf_i terminal)
        then share one XLA executable — the structural-interpreter
        compile-cache strategy (SURVEY.md §7.4).  Returns
        (step, omega_values) where omega_values are this expression's
        factors in canonical slot order.
        """
        from evostencils_tpu.ir.transformations import collect_cycles

        cycles = collect_cycles(expression)
        slots = {id(c): i for i, c in enumerate(cycles)}
        omega_values = [float(c.relaxation_factor) for c in cycles]
        multiref = self._multiref_ids(expression)

        def step(u: Tuple, f: Tuple, omegas) -> Tuple:
            memo = {}

            def omega_lookup(node):
                return omegas[slots[id(node)]]

            def ev(node):
                key = id(node)
                if key in memo:
                    return memo[key]
                value = self._eval(node, ev, u, f, omega_lookup, multiref)
                memo[key] = value
                return value

            return ev(expression)

        return step, omega_values

    @staticmethod
    def _multiref_ids(expression) -> frozenset:
        """ids of DAG nodes referenced by more than one parent.  Smoothing
        chains are only scan-fused across single-consumer links: a shared
        intermediate iterate must stay memoizable by the normal walk.

        A smoothing cycle references its own iterate twice by construction
        (node.approximation and the correction's Residual.approximation are
        the same object) — that self-reference is discounted, otherwise no
        chain link would ever qualify."""
        counts = {}
        cycles = []

        def visit(e):
            if e is None or not isinstance(e, base.Expression):
                return
            counts[id(e)] = counts.get(id(e), 0) + 1
            if counts[id(e)] > 1:
                return
            if isinstance(e, base.Cycle):
                cycles.append(e)
                visit(e.approximation), visit(e.rhs), visit(e.correction)
            elif isinstance(e, base.Residual):
                visit(e.approximation), visit(e.rhs)
            elif isinstance(e, base.BinaryExpression):
                visit(e.operand1), visit(e.operand2)
            elif isinstance(e, (base.UnaryExpression, base.Scaling)):
                visit(e.operand)

        visit(expression)
        for c in cycles:
            corr = c.correction
            if (
                isinstance(corr, base.Multiplication)
                and isinstance(corr.operand1, base.Inverse)
                and isinstance(corr.operand2, base.Residual)
                and corr.operand2.approximation is c.approximation
            ):
                counts[id(c.approximation)] -= 1
        return frozenset(k for k, v in counts.items() if v > 1)

    def _zeros_for(self, node) -> Tuple:
        grids = node.grid if isinstance(node.grid, list) else [node.grid]
        return tuple(
            jnp.zeros(g.interior_shape, dtype=self.dtype) for g in grids
        )

    def _eval(self, node, ev, u, f, omega_lookup, multiref=frozenset()):
        if isinstance(node, (system.ZeroApproximation, base.ZeroApproximation)):
            return self._zeros_for(node)
        if isinstance(node, (system.RightHandSide, base.RightHandSide)):
            return tuple(f)
        if isinstance(node, (system.Approximation, base.Approximation)):
            return tuple(u)
        if isinstance(node, base.Cycle):
            chain = self._smoothing_chain(node, multiref)
            if chain is not None:
                return self._eval_smoothing_chain(chain, ev, omega_lookup)
            return self._eval_cycle(node, ev, omega_lookup)
        if isinstance(node, base.Residual):
            rhs_val = ev(node.rhs)
            approx_val = ev(node.approximation)
            a_u = self.system_apply(node.operator, approx_val)
            return sops.tree_sub(rhs_val, a_u)
        if isinstance(node, base.Multiplication):
            op1 = node.operand1
            if isinstance(op1, base.Inverse):
                u_state = (
                    ev(node.operand2.approximation)
                    if isinstance(node.operand2, base.Residual)
                    else None
                )
                return self.smoother_apply(op1.operand, ev(node.operand2), u_state)
            if isinstance(op1, base.CoarseGridSolver):
                return self.cgs_apply(op1, ev(node.operand2), node.operand2, ev)
            if isinstance(op1, KrylovSubspaceMethod):
                apply_a = partial(self.system_apply, op1.operator)
                return krylov.SOLVERS[op1.name](
                    apply_a, ev(node.operand2), op1.number_of_iterations
                )
            if isinstance(op1, system.InterGridOperator):
                return self.intergrid_apply(op1, ev(node.operand2))
            if isinstance(op1, system.Operator):
                return self.system_apply(op1, ev(node.operand2))
            raise RuntimeError(f"Unsupported multiplication lhs: {op1!r}")
        if isinstance(node, base.Addition):
            return sops.tree_add(ev(node.operand1), ev(node.operand2))
        if isinstance(node, base.Subtraction):
            return sops.tree_sub(ev(node.operand1), ev(node.operand2))
        if isinstance(node, base.Scaling):
            return sops.tree_scale(node.factor, ev(node.operand))
        raise RuntimeError(f"Cannot evaluate IR node {type(node).__name__}")

    def _smoothing_parts(self, node: base.Cycle):
        """(B, A, rhs_expr, kind) if the cycle is a plain smoothing step
        u' = u + ω·P·B⁻¹(rhs − A·u) of its own iterate, else None.

        kind "single": full update — requires the residual to be formed
        against the cycle's own approximation (otherwise the generic
        correction path applies).  kind "rb": the red-black two-sweep
        always recomputes the residual against the chained iterate, so
        only the correction's shape matters.
        """
        corr = node.correction
        if not (
            isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual)
        ):
            return None
        residual = corr.operand2
        if _is_partitioning(node.partitioning, part.RedBlack):
            kind = "rb"
        elif (
            _is_partitioning(node.partitioning, part.Single)
            and residual.approximation is node.approximation
        ):
            kind = "single"
        else:
            return None
        return corr.operand1.operand, residual.operator, residual.rhs, kind

    def _apply_smoothing(self, u_cur, f_val, B, A, kind, omega):
        """One smoothing update u' = u + ω·P·B⁻¹(f − A·u) (both colors for
        red-black).  Shared by the unrolled cycle walk and the scan-fused
        smoothing chains, so the two lowerings are the same math."""
        if kind == "single":
            r = sops.tree_sub(tuple(f_val), self.system_apply(A, u_cur))
            corr = self.smoother_apply(B, r, u_cur)
            return tuple(x + omega * c for x, c in zip(u_cur, corr))
        # XLA fuses each colour's residual and masked update into one loop;
        # measured on an H100 SXM (700 W) this beats a hand-fused
        # Pallas/Triton red-black kernel per step and per V(2,1) cycle.
        masks_per_field = [
            sops.red_black_masks(x.shape, dtype=jnp.float32) for x in u_cur
        ]
        for color in range(2):
            a_u = self.system_apply(A, u_cur)
            r = sops.tree_sub(tuple(f_val), a_u)
            corr = self.smoother_apply(B, r, u_cur)
            u_cur = tuple(
                x + omega * masks[color].astype(x.dtype) * c
                for x, c, masks in zip(u_cur, corr, masks_per_field)
            )
        return u_cur

    def _smoothing_signature(self, info):
        B, A, _, kind = info
        return (kind, canonical_string(B), canonical_string(A))

    def _smoothing_chain(self, node: base.Cycle, multiref):
        """Maximal run of ≥2 consecutive smoothing cycles that differ only
        in ω: same smoother/operator structure, same rhs expression object,
        linked iterate with no outside consumer.  Returned outermost-first;
        None when the node is not the head of such a run."""
        info = self._smoothing_parts(node)
        if info is None:
            return None
        sig = self._smoothing_signature(info)
        chain = [node]
        cur = node
        while True:
            child = cur.approximation
            if not isinstance(child, base.Cycle) or id(child) in multiref:
                break
            child_info = self._smoothing_parts(child)
            if (
                child_info is None
                or child_info[2] is not info[2]
                or self._smoothing_signature(child_info) != sig
            ):
                break
            chain.append(child)
            cur = child
        return chain if len(chain) >= 2 else None

    def _eval_smoothing_chain(self, chain, ev, omega_lookup):
        """Lower a smoothing chain as one lax.scan over its ω slice.

        The step body is traced (and staged to HLO) once instead of
        len(chain) times — the dominant per-individual cost on this
        pipeline is XLA compilation of the evolved structure, and evolved
        trees repeat the same smoothing production many times per level
        (reference trees too: V(ν₁,ν₂) cycles).
        """
        import jax

        B, A, rhs_expr, kind = self._smoothing_parts(chain[0])
        base_u = tuple(ev(chain[-1].approximation))
        f_val = ev(rhs_expr)
        ordered = list(reversed(chain))  # innermost applied first
        # ω must not upcast the scan carry (a float64 ω on float32 fields
        # would change the carry dtype between iterations): keep it at the
        # field dtype's real precision.
        real_dt = np.zeros((), dtype=np.dtype(jnp.dtype(self.dtype))).real.dtype
        if omega_lookup is None:
            omegas = jnp.asarray(
                np.asarray([c.relaxation_factor for c in ordered], dtype=real_dt)
            )
        else:
            omegas = jnp.stack([omega_lookup(c) for c in ordered]).astype(real_dt)

        def body(u, w):
            return self._apply_smoothing(u, f_val, B, A, kind, w), None

        u_final, _ = jax.lax.scan(body, base_u, omegas)
        return u_final

    def _eval_cycle(self, node: base.Cycle, ev, omega_lookup=None):
        # Grammar relaxation factors are np.float64 scalars (np.linspace,
        # grammar/multigrid.py): coerce to weak Python floats so f32
        # fields are not upcast under jax_enable_x64.
        omega = (
            float(node.relaxation_factor)
            if omega_lookup is None
            else omega_lookup(node)
        )
        u0 = ev(node.approximation)
        if not _is_partitioning(node.partitioning, part.Single) and not _is_partitioning(
            node.partitioning, part.RedBlack
        ):
            raise RuntimeError(f"Unknown partitioning {node.partitioning!r}")
        info = self._smoothing_parts(node)
        if info is None:
            # Generic correction (coarse-grid, Krylov, non-chained residual)
            # — single full update; partitioning only applies to smoothing
            # corrections (matches the LFA evaluator raising / codegen
            # ignoring partitioning there).
            corr = ev(node.correction)
            return tuple(x + omega * c for x, c in zip(u0, corr))
        B, A, rhs_expr, kind = info
        f_val = ev(rhs_expr)
        return self._apply_smoothing(tuple(u0), f_val, B, A, kind, omega)
