"""Smoother application kernels.

The grammar only ever emits corrections of the form `Inverse(B) * r`.
This module provides the array-level implementations for every smoothing
operator family B (reference ir/smoother.py semantics):

  * decoupled Jacobi   — per-field reciprocal of the operator diagonal,
  * collective Jacobi  — per-gridpoint n_fields×n_fields solve,
  * collective block Jacobi — per-block dense solve over a small spatial
    window, applied as a sum of masked shifts of the precomputed inverse
    (BlockSolveSpec.apply),
  * symmetric/lower/upper splittings via generic periodic-stencil apply.

All heavy precomputation (tiny dense inverses) happens in numpy at
lowering time; at runtime only fused elementwise ops remain.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.stencils import periodic


def decoupled_jacobi_apply(r_fields: Sequence[jax.Array], inv_diags) -> Tuple[jax.Array, ...]:
    """corr_i = r_i / diag(A_ii); inv_diags are scalars or coefficient planes."""
    return tuple(inv * r for inv, r in zip(inv_diags, r_fields))


def collective_jacobi_apply(
    r_fields: Sequence[jax.Array], inv_center: np.ndarray
) -> Tuple[jax.Array, ...]:
    """Per-gridpoint solve of the n×n center-coefficient matrix.

    inv_center: (n, n) constant matrix (the per-point matrix is identical
    at every point for constant-coefficient operators).
    """
    n = len(r_fields)
    out = []
    for i in range(n):
        acc = None
        for j in range(n):
            # Python scalar (weak type) so the field dtype always wins —
            # an np.float64 scalar would upcast f32 fields under x64.
            coeff = complex(inv_center[i, j])
            if coeff == 0.0:
                continue
            if coeff.imag == 0.0:
                coeff = coeff.real
            term = coeff * r_fields[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else jnp.zeros_like(r_fields[i]))
    return tuple(out)


def collective_jacobi_apply_variable(
    r_fields: Sequence[jax.Array], inv_center_planes
) -> Tuple[jax.Array, ...]:
    """Variable-coefficient collective Jacobi: inv_center_planes[i][j] is a
    plane (or scalar 0 for structurally-zero couplings)."""
    n = len(r_fields)
    out = []
    for i in range(n):
        acc = None
        for j in range(n):
            plane = inv_center_planes[i][j]
            if plane is None:
                continue
            term = plane * r_fields[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else jnp.zeros_like(r_fields[i]))
    return tuple(out)


def _shift(r: jax.Array, d: Tuple[int, ...]) -> jax.Array:
    """out[x] = r[x + d], zero-filled outside the array."""
    if all(da == 0 for da in d):
        return r
    src = tuple(slice(max(da, 0), n + min(da, 0)) for da, n in zip(d, r.shape))
    pads = [(max(-da, 0), max(da, 0)) for da in d]
    return jnp.pad(r[src], pads)


class BlockSolveSpec:
    """Precomputed data for a collective block-Jacobi local solve.

    The interior of every field is tiled by an anchor period `period`
    (elementwise lcm of all per-field block shapes).  The local matrix L
    couples all fields × period cells; rows of padded cells are identity.
    `inv_l` is L^{-1} (numpy, computed once at lowering time).

    Runtime formulation: L^{-1} is itself a PERIODIC operator (identical
    blocks tile the grid), so its application is a sum of full-array
    shifts weighted by period-tiled coefficient planes:

        out_i[x] = Σ_j Σ_d  C_{ijd}[x mod period] · r_j[x + d]

    — pure fused elementwise ops, no transposes.  Measured on an H100 SXM
    (700 W) at 1023² f32, this is as fast as or faster than gathering the
    blocks into one batched matmul at Precision.HIGHEST for every block
    shape tried: 19.1 vs 19.7 µs for period (8, 1), 18.6 vs 19.8 µs for
    (1, 8), 15.9 vs 39.8 µs for (2, 2), 14.1 vs 36.1 µs for (4, 1)."""

    def __init__(self, period: Tuple[int, ...], n_fields: int, inv_l: np.ndarray, dtype):
        self.period = period
        self.n_fields = n_fields
        # numpy, not jnp: the spec is cached across jit traces.
        self.inv_l = np.asarray(inv_l, dtype=np.dtype(jnp.dtype(dtype)))
        self._build_shift_planes()

    def _build_shift_planes(self):
        """Group L^{-1} entries by inter-field pair and displacement d:
        planes[(i, j)][d] is a `period`-shaped coefficient array."""
        period = self.period
        cells = list(np.ndindex(*period))
        cell_index = {c: k for k, c in enumerate(cells)}
        nc = len(cells)
        self.shift_planes = {}
        for i in range(self.n_fields):
            for j in range(self.n_fields):
                by_d = {}
                for alpha in cells:
                    for beta in cells:
                        v = self.inv_l[i * nc + cell_index[alpha],
                                       j * nc + cell_index[beta]]
                        if v == 0:
                            continue
                        d = tuple(b - a for a, b in zip(alpha, beta))
                        plane = by_d.get(d)
                        if plane is None:
                            plane = np.zeros(period, dtype=self.inv_l.dtype)
                            by_d[d] = plane
                        plane[alpha] = v
                if by_d:
                    self.shift_planes[(i, j)] = by_d

    def _periodic_plane(self, plane: np.ndarray, shape) -> jax.Array:
        """Full-shape array with value plane[x mod period] — built as a
        fused iota+select chain (a jnp.tile of a 2-D-periodic plane
        materializes through an XLA tiling-unfriendly reshape and costs
        milliseconds at 1023²; the select chain fuses to nothing)."""
        period = self.period
        mods = [
            jax.lax.broadcasted_iota(jnp.int32, shape, a) % p if p > 1 else None
            for a, p in enumerate(period)
        ]
        acc = jnp.zeros(shape, dtype=self.inv_l.dtype)
        for alpha in np.ndindex(*period):
            v = plane[alpha]
            if v == 0:
                continue
            mask = None
            for a, (ai, m) in enumerate(zip(alpha, mods)):
                if m is None:
                    continue
                cond = m == ai
                mask = cond if mask is None else jnp.logical_and(mask, cond)
            coeff = complex(v)
            if coeff.imag == 0.0:
                coeff = coeff.real
            acc = acc + coeff * mask.astype(acc.dtype) if mask is not None else (
                acc + coeff * jnp.ones(shape, dtype=acc.dtype)
            )
        return acc

    def apply(self, r_fields: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
        """out = L⁻¹ r blockwise, as masked shifts (class docstring)."""
        shape = r_fields[0].shape
        out = []
        for i in range(self.n_fields):
            acc = None
            for j in range(self.n_fields):
                by_d = self.shift_planes.get((i, j))
                if not by_d:
                    continue
                for d, plane in by_d.items():
                    vals = plane[plane != 0]
                    if vals.size and np.all(vals == vals.flat[0]) and not np.any(
                        plane == 0
                    ):
                        # Uniform plane: scalar weight, no masking at all.
                        coeff = complex(vals.flat[0])
                        if coeff.imag == 0.0:
                            coeff = coeff.real
                        term = coeff * _shift(r_fields[j], d)
                    else:
                        term = self._periodic_plane(plane, shape) * _shift(
                            r_fields[j], d
                        )
                    acc = term if acc is None else acc + term
            out.append(acc if acc is not None else jnp.zeros_like(r_fields[i]))
        return tuple(out)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_block_solve_spec(
    smoothing_operator_entries,
    block_sizes: Sequence[Tuple[int, ...]],
    interior_shape: Tuple[int, ...],
    dtype,
) -> BlockSolveSpec:
    """Assemble and invert the local block matrix.

    smoothing_operator_entries[i][j]: periodic stencil of the (already
    block-diagonal-filtered) coupling from field j to field i.
    """
    n_fields = len(smoothing_operator_entries)
    dim = len(interior_shape)
    period = tuple(
        reduce(_lcm, (bs[axis] for bs in block_sizes), 1) for axis in range(dim)
    )
    cells = list(np.ndindex(*period))
    cell_index = {c: k for k, c in enumerate(cells)}
    n_cell = len(cells)
    n = n_fields * n_cell
    L = np.zeros((n, n), dtype=np.complex128)
    for i in range(n_fields):
        for j in range(n_fields):
            stencil = periodic.lift(smoothing_operator_entries[i][j])
            if stencil is None:
                continue
            for alpha in cells:
                cell_stencil = stencil[alpha]
                if cell_stencil is None:
                    continue
                row = i * n_cell + cell_index[alpha]
                for offset, value in cell_stencil.entries:
                    beta = tuple((a + o) % p for a, o, p in zip(alpha, offset, period))
                    # block-diagonal filtering guarantees alpha+offset stays
                    # inside the block, so the modulo never wraps couplings.
                    target = tuple(a + o for a, o in zip(alpha, offset))
                    if any(t < 0 or t >= p for t, p in zip(target, period)):
                        continue
                    col = j * n_cell + cell_index[beta]
                    L[row, col] += value
    # Identity rows for structurally empty equations keep L invertible.
    for row in range(n):
        if not np.any(L[row, :]):
            L[row, row] = 1.0
    inv_l = np.linalg.inv(L)
    if not np.iscomplexobj(np.zeros((), dtype=dtype)):
        inv_l = np.real(inv_l)
    return BlockSolveSpec(period, n_fields, inv_l, dtype)
