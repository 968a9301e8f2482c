"""Structural-interpreter VM: one XLA executable runs *any* evolved cycle.

The per-individual cost on this pipeline is XLA compilation.  The
per-structure compile cache (backend/evaluation.py) removes duplicate
compilations, but a population of *distinct* structures still pays one
compile apiece — the analog of the reference's per-individual
java + make pipeline (reference code_generation/exastencils.py:329-415).

This module removes the per-structure compile entirely for the linear
multigrid grammar: the grammar's guard-type discipline (reference
optimization/multigrid.py:238-385 — state `(u, f)` is threaded linearly
through every production) means every evolved tree IS a straight-line
instruction sequence over a level-indexed state.  So we compile ONE
interpreter per problem:

    state   = (u[0..L], f[0..L])       one (fields-tuple) pair per level
    program = (opcodes i32[PAD], omegas f32[PAD], length i32)
    step    = lax.fori_loop over lax.switch(opcode) branches

and every individual becomes *data* — two small arrays.  Evaluating a new
structure costs a dispatch, not a compile.

ISA (branches are enumerated per level with the operators baked in):
    NOP
    SMOOTH[B, partitioning, level](ω)   u_l += ω·P·B⁻¹(f_l − A_l·u_l)
    RESTRICT[R, A, level]               f_{l+1} = R(f_l − A_l·u_l); u_{l+1} = 0
    CGS[solver, level]                  u_l = A_l⁻¹ f_l  (dense / Krylov / nested)
    PROLONG[P, level](ω)                u_l += ω·P·u_{l+1}

The standard grammar surface (point + block-Jacobi smoothers over all legal
block shapes, both partitionings, default transfer operators, the coarse
solver) is pre-registered so the ISA is stable from the first individual;
anything novel (CMA-ES-optimized transfer stencils, alternative Krylov
coarse solvers) registers lazily and bumps `isa_version`, which forces one
interpreter recompile.  Expressions outside the ISA (FAS Newton smoothing,
sub-expression sharing) simply fail translation and fall back to the
per-structure lowering path.

vmap caveat: the interpreter must only ever be vmapped over `omegas`
(same-structure groups).  Batching `opcodes` would batch the switch
predicate, and vmap of a batched-predicate switch executes ALL branches
masked — a ~|ISA|× blowup.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.ir import base, partitioning as part, system
from evostencils_tpu.ir.krylov import KrylovSubspaceMethod
from evostencils_tpu.ir.transformations import canonical_string
from evostencils_tpu.ops import krylov as krylov_ops
from evostencils_tpu.ops import stencil_ops as sops

PROGRAM_PAD = 64
# Programs are padded to the smallest class that fits; the interpreter is
# jit-compiled per padded shape (jax's signature cache), so all programs in
# one class share one executable and the common ≤64-instruction population
# never pays for the rare deep/size-150 tree (grammar cap: gp.py gen_grow
# regenerates >150-node trees, reference grammar/gp.py:46-52).  The largest
# class bounds every legal tree: each grammar production emits at most two
# instructions, so 150 nodes can never exceed 320 instructions.
PAD_CLASSES = (PROGRAM_PAD, 160, 320)


class Program(NamedTuple):
    opcodes: np.ndarray  # int32[PROGRAM_PAD]
    omegas: np.ndarray  # float32[PROGRAM_PAD]
    length: int

    def as_arguments(self):
        return (
            jnp.asarray(self.opcodes),
            jnp.asarray(self.omegas),
            jnp.asarray(self.length, dtype=jnp.int32),
        )


class _NotTranslatable(Exception):
    pass


def _replace(t: tuple, i: int, v):
    return t[:i] + (v,) + t[i + 1 :]


class CycleVM:
    """Interpreter for one problem hierarchy (finest level fixed).

    `include_block_smoothers=False` builds a SLIM ISA (point smoothers +
    transfers + CGS only): outer-Krylov evaluations inline the interpreter
    body twice per BiCGStab iteration, and the full ~43-branch ISA makes
    that graph compile much more slowly.  Block-smoother individuals then
    simply fail translation and take the per-structure lowering path — the
    right trade when the interpreter executable is shared by a whole
    population."""

    def __init__(self, lowering, problem, finest_level: int,
                 include_block_smoothers: bool = True):
        self.lowering = lowering
        self.problem = problem
        self.include_block_smoothers = include_block_smoothers
        self.finest_level = finest_level
        self.n_levels = finest_level - problem.min_level + 1
        # Per-level interior shapes, one per field (0 = finest).
        self._shapes: List[List[tuple]] = [
            [g.interior_shape for g in problem.grid_at(finest_level - i)]
            for i in range(self.n_levels)
        ]
        self._op_index = {}
        self._branches = [self._nop_branch()]
        self.isa_version = 0
        self.last_failure = None  # "not_translatable" | "pad_overflow"
        # Lazy opcode registration happens from the threaded precompile
        # pipeline: without the lock, two threads can bind an opcode key to
        # another op's branch index (silently wrong execution).
        self._op_lock = threading.Lock()
        self._preregister()

    # ------------------------------------------------------------------
    # ISA construction
    # ------------------------------------------------------------------

    def _nop_branch(self):
        def nop(state, omega):
            return state

        return nop

    def _opcode(self, key, make_branch) -> int:
        idx = self._op_index.get(key)
        if idx is not None:
            return idx
        with self._op_lock:
            idx = self._op_index.get(key)  # re-check under the lock
            if idx is not None:
                return idx
            idx = len(self._branches)
            self._branches.append(make_branch())
            self._op_index[key] = idx
            self.isa_version += 1
            return idx

    def _level_index(self, expr) -> int:
        grids = expr.grid if isinstance(expr.grid, list) else [expr.grid]
        idx = self.finest_level - grids[0].level
        if not 0 <= idx < self.n_levels:
            raise _NotTranslatable(f"level {grids[0].level} outside hierarchy")
        return idx

    def _smooth_opcode(self, B, A, partitioning, level: int) -> int:
        from evostencils_tpu.ir.partitioning import RedBlack, Single

        if partitioning is RedBlack or isinstance(partitioning, RedBlack):
            kind = "rb"
        elif partitioning is Single or isinstance(partitioning, Single):
            kind = "single"
        else:
            raise _NotTranslatable(f"partitioning {partitioning!r}")
        if not self.include_block_smoothers and isinstance(B, system.Operator):
            # Slim ISA: never register block solves lazily — that would
            # bump isa_version and force the expensive shared recompile.
            raise _NotTranslatable("block smoother outside slim ISA")
        key = ("smooth", level, kind, canonical_string(B))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                u_l = lowering._apply_smoothing(u[level], f[level], B, A, kind, omega)
                return (_replace(u, level, u_l), f)

            return branch

        return self._opcode(key, make)

    def _restrict_opcode(self, R, A, level: int) -> int:
        key = ("restrict", level, canonical_string(R), canonical_string(A))
        lowering = self.lowering
        coarse_shapes = self._shapes[level + 1]
        dtype = lowering.dtype

        def make():
            def branch(state, omega):
                u, f = state
                r = sops.tree_sub(f[level], lowering.system_apply(A, u[level]))
                f_c = lowering.intergrid_apply(R, r)
                u_c = tuple(jnp.zeros(s, dtype=dtype) for s in coarse_shapes)
                return (_replace(u, level + 1, u_c), _replace(f, level + 1, f_c))

            return branch

        return self._opcode(key, make)

    def _prolong_opcode(self, P, level: int) -> int:
        key = ("prolong", level, canonical_string(P))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                corr = lowering.intergrid_apply(P, u[level + 1])
                u_l = tuple(x + omega * c for x, c in zip(u[level], corr))
                return (_replace(u, level, u_l), f)

            return branch

        return self._opcode(key, make)

    def _cgs_opcode(self, solver: base.CoarseGridSolver, level: int) -> int:
        if self.lowering._nonlinear_entries(solver.operator) is not None:
            raise _NotTranslatable("nonlinear coarse solve")
        key = ("cgs", level, canonical_string(solver))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                u_c = lowering.cgs_apply(solver, f[level])
                return (_replace(u, level, u_c), f)

            return branch

        return self._opcode(key, make)

    def _preregister(self):
        """Register the full standard grammar surface up front so the ISA —
        and with it the compiled interpreter — is stable across individuals
        (reference multigrid.py:349-385 enumerates the same productions)."""
        from evostencils_tpu.grammar import multigrid as mg
        from evostencils_tpu.ir import smoother as sm

        problem = self.problem
        scalar = len(problem.fields) == 1
        max_block = 8
        block_shapes = []
        if scalar and self.include_block_smoothers:
            import itertools

            for shape in itertools.product(
                range(1, max_block + 1), repeat=problem.dimension
            ):
                total = int(np.prod(shape))
                if 1 < total <= max_block:
                    block_shapes.append((shape,))

        for i in range(self.n_levels):
            level = self.finest_level - i
            grids = problem.grid_at(level)
            coarse = problem.grid_at(level - 1)
            if i == self.n_levels - 1:
                A = mg.generate_system_operator(
                    problem.equations, problem.operators, problem.fields,
                    level, i, grids,
                )
                solver = base.CoarseGridSolver("CGS", A, None)
                try:
                    self._cgs_opcode(solver, i)
                except _NotTranslatable:
                    pass
                break
            A, R, P = mg.generate_operators_on_level(
                problem.equations, problem.operators, problem.fields,
                level, i, grids, coarse,
            )
            for partitioning in (part.Single, part.RedBlack):
                self._smooth_opcode(
                    sm.generate_collective_jacobi(A), A, partitioning, i
                )
                if not scalar:
                    self._smooth_opcode(
                        sm.generate_decoupled_jacobi(A), A, partitioning, i
                    )
            for bs in block_shapes:
                try:
                    self._smooth_opcode(
                        sm.generate_collective_block_jacobi(A, bs), A, part.Single, i
                    )
                except Exception:
                    continue
            self._restrict_opcode(R, A, i)
            self._prolong_opcode(P, i)

    # ------------------------------------------------------------------
    # Translation: IR expression -> instruction list
    # ------------------------------------------------------------------

    def translate(self, expression) -> Optional[Program]:
        """Program for `expression`, or None if outside the ISA.

        Matches the exact node shapes the grammar's productions construct
        (grammar/multigrid.py:280-394): smoothing corrections, coarsening
        chains bottoming out in a ZeroApproximation whose rhs is the
        restricted residual, and coarsest-level CGS corrections."""
        instrs: List[Tuple[int, float]] = []
        self.last_failure = None
        try:
            self._emit(expression, instrs)
        except _NotTranslatable:
            self.last_failure = "not_translatable"
            return None
        if not instrs:
            self.last_failure = "not_translatable"
            return None
        pad = next((p for p in PAD_CLASSES if len(instrs) <= p), None)
        if pad is None:
            self.last_failure = "pad_overflow"
            return None
        opcodes = np.zeros((pad,), dtype=np.int32)
        omegas = np.ones((pad,), dtype=np.float32)
        for i, (op, w) in enumerate(instrs):
            opcodes[i] = op
            omegas[i] = w
        return Program(opcodes, omegas, len(instrs))

    def _emit(self, expr, instrs):
        if isinstance(expr, (system.Approximation, base.Approximation)) and not isinstance(
            expr, (system.ZeroApproximation, base.ZeroApproximation)
        ):
            if self._level_index(expr) != 0:
                raise _NotTranslatable("non-finest initial approximation")
            return
        if isinstance(expr, (system.ZeroApproximation, base.ZeroApproximation)):
            # Base of a coarse chain: the preceding RESTRICT already zeroed
            # the iterate and bound the level's rhs.
            return
        if not isinstance(expr, base.Cycle):
            raise _NotTranslatable(f"unexpected node {type(expr).__name__}")

        level = self._level_index(expr)
        corr = expr.correction
        omega = float(expr.relaxation_factor)

        # Smoothing: u' = u + ω·P·B⁻¹(f − A·u)  (grammar `smoothing`).
        if (
            isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual)
            and corr.operand2.approximation is expr.approximation
            and corr.operand2.rhs is expr.rhs
        ):
            self._emit(expr.approximation, instrs)
            opcode = self._smooth_opcode(
                corr.operand1.operand, corr.operand2.operator,
                expr.partitioning, level,
            )
            instrs.append((opcode, omega))
            return

        # Coarse-grid correction: u' = u + ω·P·(coarse result)
        # (grammar `update_with_coarse_grid_correction` /
        # `correct_with_coarse_grid_solver`).
        if isinstance(corr, base.Multiplication) and isinstance(
            corr.operand1, system.InterGridOperator
        ):
            P, sub = corr.operand1, corr.operand2
            if isinstance(sub, base.Cycle):
                rhs_c = self._chain_rhs(sub)
                restrict_op = self._match_restricted_rhs(rhs_c, expr, level)
                self._emit(expr.approximation, instrs)
                instrs.append((restrict_op, 1.0))
                self._emit(sub, instrs)
            elif (
                isinstance(sub, base.Multiplication)
                and isinstance(sub.operand1, base.CoarseGridSolver)
            ):
                restrict_op = self._match_restricted_rhs(sub.operand2, expr, level)
                self._emit(expr.approximation, instrs)
                instrs.append((restrict_op, 1.0))
                instrs.append((self._cgs_opcode(sub.operand1, level + 1), 1.0))
            else:
                raise _NotTranslatable("unrecognized coarse correction")
            instrs.append((self._prolong_opcode(P, level), omega))
            return

        raise _NotTranslatable("unrecognized correction shape")

    def _chain_rhs(self, cycle: base.Cycle):
        """The shared rhs object of a coarse cycle chain (every production
        at one level threads the same rhs)."""
        return cycle.rhs

    def _match_restricted_rhs(self, rhs_c, parent: base.Cycle, level: int) -> int:
        """rhs_c must be R·(f − A·u) of the parent's own state; returns the
        RESTRICT opcode."""
        if not (
            isinstance(rhs_c, base.Multiplication)
            and isinstance(rhs_c.operand1, system.InterGridOperator)
            and isinstance(rhs_c.operand2, base.Residual)
        ):
            raise _NotTranslatable("coarse rhs is not a restricted residual")
        residual = rhs_c.operand2
        if (
            residual.approximation is not parent.approximation
            or residual.rhs is not parent.rhs
        ):
            raise _NotTranslatable("restricted residual of a foreign state")
        return self._restrict_opcode(rhs_c.operand1, residual.operator, level)

    # ------------------------------------------------------------------
    # Interpreter
    # ------------------------------------------------------------------

    def make_step(self):
        """step(u_fields, f_fields, program) -> u_fields at the finest
        level — drop-in compatible with the lowered per-structure step,
        with the cycle structure as a traced argument."""
        branches = tuple(self._branches)
        shapes = self._shapes
        dtype = self.lowering.dtype
        n_levels = self.n_levels

        def step(u: Tuple, f: Tuple, program) -> Tuple:
            opcodes, omegas, length = program
            u_all = (tuple(u),) + tuple(
                tuple(jnp.zeros(s, dtype=dtype) for s in shapes[i])
                for i in range(1, n_levels)
            )
            f_all = (tuple(f),) + tuple(
                tuple(jnp.zeros(s, dtype=dtype) for s in shapes[i])
                for i in range(1, n_levels)
            )

            def body(i, state):
                return jax.lax.switch(opcodes[i], branches, state, omegas[i])

            u_final, _ = jax.lax.fori_loop(0, length, body, (u_all, f_all))
            return u_final[0]

        return step
