"""Coarse-grid solver: direct dense solve via a precomputed inverse.

The coarsest grids of the evolved hierarchies are tiny (≤ a few thousand
unknowns), so the coarse system matrix is assembled once (numpy, at
lowering time), inverted, and the solve applied as a single dense
matrix-vector product on device — no iteration overhead and no host
synchronization.  This replaces the reference's
`gen_mgCycle@coarsest` CG/BiCGStab calls inside generated C++
(reference code_generation/exastencils.py:896,1025-1101); iterative coarse
solvers remain available through ops/krylov.py when the grammar supplies a
CoarseGridSolver expression.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.stencils import periodic


def assemble_scalar_matrix(
    stencil, interior_shape: Tuple[int, ...], planes=None
) -> np.ndarray:
    """Dense matrix of a (periodic/constant/variable) stencil operator with
    homogeneous Dirichlet boundary (couplings leaving the interior drop)."""
    n = int(np.prod(interior_shape))
    A = np.zeros((n, n), dtype=np.complex128)
    grids = np.meshgrid(*[np.arange(s) for s in interior_shape], indexing="ij")
    flat_index = np.ravel_multi_index([g.ravel() for g in grids], interior_shape)

    if planes is not None:
        offsets, coeff_planes = planes
        for offset, plane in zip(offsets, coeff_planes):
            target = [g.ravel() + o for g, o in zip(grids, offset)]
            valid = np.ones(n, dtype=bool)
            for t, s in zip(target, interior_shape):
                valid &= (t >= 0) & (t < s)
            rows = flat_index[valid]
            cols = np.ravel_multi_index(
                [t[valid] for t in target], interior_shape
            )
            A[rows, cols] += np.asarray(plane).ravel()[valid]
        return A

    pstencil = periodic.lift(stencil)
    period = pstencil.period
    cell_of_point = sum(
        (g.ravel() % p) * int(np.prod(period[k + 1 :]))
        for k, (g, p) in enumerate(zip(grids, period))
    )
    for cell_id, index in enumerate(np.ndindex(*period)):
        cell = pstencil.cells[index]
        if cell is None or cell.number_of_entries == 0:
            continue
        in_cell = cell_of_point == cell_id
        for offset, value in cell.entries:
            target = [g.ravel() + o for g, o in zip(grids, offset)]
            valid = in_cell.copy()
            for t, s in zip(target, interior_shape):
                valid &= (t >= 0) & (t < s)
            rows = flat_index[valid]
            cols = np.ravel_multi_index([t[valid] for t in target], interior_shape)
            A[rows, cols] += value
    return A


class DenseSolveSpec:
    """Precomputed dense inverse of a (block) system operator."""

    def __init__(self, inv_matrix: np.ndarray, field_shapes, dtype):
        # Keep numpy: the spec is cached across jit traces, so device
        # constants must be materialized inside each trace, not stored.
        self.inv = np.asarray(inv_matrix, dtype=np.dtype(jnp.dtype(dtype)))
        self.field_shapes = field_shapes
        self.sizes = [int(np.prod(s)) for s in field_shapes]

    def apply(self, r_fields: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
        flat = jnp.concatenate([r.reshape(-1) for r in r_fields])
        # HIGHEST: a float32 product may otherwise run in TF32 on the GPU
        # (~1e-3 relative error), which changes the coarse correction.
        sol = jnp.matmul(jnp.asarray(self.inv), flat,
                         precision=jax.lax.Precision.HIGHEST)
        out = []
        start = 0
        for size, shape in zip(self.sizes, self.field_shapes):
            out.append(sol[start : start + size].reshape(shape))
            start += size
        return tuple(out)


def build_dense_solve_spec(entry_matrices, field_shapes, dtype) -> DenseSolveSpec:
    """entry_matrices[i][j]: dense numpy block (or None for zero blocks)."""
    sizes = [int(np.prod(s)) for s in field_shapes]
    n = sum(sizes)
    A = np.zeros((n, n), dtype=np.complex128)
    row0 = 0
    for i, row in enumerate(entry_matrices):
        col0 = 0
        for j, block in enumerate(row):
            if block is not None:
                A[row0 : row0 + sizes[i], col0 : col0 + sizes[j]] = block
            col0 += sizes[j]
        row0 += sizes[i]
    inv = np.linalg.inv(A)
    if not np.iscomplexobj(np.zeros((), dtype=dtype)):
        inv = np.real(inv)
    return DenseSolveSpec(inv, field_shapes, dtype)
