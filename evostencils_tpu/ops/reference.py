"""Plain float64 numpy references for the device kernels.

Each function here restates the semantics of one lowered operation
without JAX, so that tests (on the CPU) and `chip_smoke.py` (on the GPU)
can compare what XLA compiled against an independent implementation:

  * `red_black_step`: one red-black collective-Jacobi step of a scalar
    constant stencil — two masked half-sweeps, the residual recomputed
    against the updated iterate between colours (backend/lowering.py);
  * `restrict` / `prolong`: the `injection ∘ stencil` intergrid transfers
    of ops/intergrid.py on the vertex-centred hierarchy;
  * `max_relative_error`: the comparison every caller uses, max|got − ref|
    over max|ref|.

A tiny helper, `red_black_cycle`, builds the IR of that smoothing step
for an arbitrary stencil and interior shape, so that a test lowers
exactly the expression evolution produces.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def shifted(u: np.ndarray, offset) -> np.ndarray:
    """out[x] = u[x + offset], zero outside the array (Dirichlet halo)."""
    out = np.zeros_like(u)
    src = tuple(slice(max(o, 0), n + min(o, 0)) for o, n in zip(offset, u.shape))
    dst = tuple(slice(max(-o, 0), n + min(-o, 0)) for o, n in zip(offset, u.shape))
    out[dst] = u[src]
    return out


def apply_stencil(u: np.ndarray, entries) -> np.ndarray:
    out = np.zeros_like(u)
    for offset, value in entries:
        out += value * shifted(u, offset)
    return out


def red_black_step(u, f, omega: float, entries) -> np.ndarray:
    """u += ω·D⁻¹(f − A·u) on red (even index sum), then on black."""
    u = np.asarray(u, np.float64)
    f = np.asarray(f, np.float64)
    entries = [(tuple(o), float(v)) for o, v in entries]
    inv_diag = 1.0 / dict(entries)[(0,) * u.ndim]
    red = (np.indices(u.shape).sum(axis=0) % 2) == 0
    for mask in (red, ~red):
        r = f - apply_stencil(u, entries)
        u = u + np.where(mask, omega * inv_diag * r, 0.0)
    return u


def restrict(fine, entries, coarse_shape: Tuple[int, ...], coarsening) -> np.ndarray:
    """coarse[ci] = Σ_o w_o · fine[c·(ci+1) − 1 + o], zero outside."""
    fine = np.asarray(fine, np.float64 if not np.iscomplexobj(fine) else np.complex128)
    index = tuple(slice(c - 1, None, c) for c in coarsening)
    out = apply_stencil(fine, entries)[index]
    return out[tuple(slice(0, m) for m in coarse_shape)]


def prolong(coarse, entries, fine_shape: Tuple[int, ...], coarsening) -> np.ndarray:
    """fine = stencil ∘ injection(coarse)."""
    coarse = np.asarray(coarse)
    dtype = np.complex128 if np.iscomplexobj(coarse) else np.float64
    injected = np.zeros(fine_shape, dtype)
    injected[tuple(slice(c - 1, None, c) for c in coarsening)] = coarse
    return apply_stencil(injected, entries)


def block_solve(r_fields, inv_l: np.ndarray, period) -> list:
    """Collective block-Jacobi local solves (ops/smoothers.BlockSolveSpec):
    the grid is tiled by `period`-shaped blocks anchored at the origin
    (boundary blocks zero-padded, then cropped), and each block's
    fields × cells vector is multiplied by the local inverse `inv_l`."""
    shape = np.shape(r_fields[0])
    padded = tuple(-(-n // p) * p for n, p in zip(shape, period))
    cells = list(np.ndindex(*period))
    crop = tuple(slice(0, n) for n in shape)
    strided = [tuple(slice(c, None, p) for c, p in zip(cell, period)) for cell in cells]
    dtype = np.result_type(np.asarray(r_fields[0]).dtype, inv_l.dtype, np.float64)
    columns = []
    for r in r_fields:
        rp = np.zeros(padded, dtype)
        rp[crop] = r
        columns.append(np.stack([rp[s].reshape(-1) for s in strided], axis=1))
    solution = np.concatenate(columns, axis=1) @ np.asarray(inv_l, dtype).T
    blocks = tuple(ps // p for ps, p in zip(padded, period))
    out = []
    for i in range(len(r_fields)):
        full = np.zeros(padded, dtype)
        for k, s in enumerate(strided):
            full[s] = solution[:, i * len(cells) + k].reshape(blocks)
        out.append(full[crop])
    return out


def max_relative_error(got, ref) -> float:
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref)))
    diff = np.max(np.abs(np.asarray(got, ref.dtype) - ref))
    return float(diff / scale) if scale > 0 else float(diff)


def red_black_cycle(stencil, interior_shape, omega: float):
    """IR of one red-black collective-Jacobi smoothing step of `stencil`
    on a grid with the given interior shape."""
    from evostencils_tpu.ir import base, smoother, system
    from evostencils_tpu.ir import partitioning as part

    size = tuple(n + 1 for n in interior_shape)
    grid = base.Grid(size, tuple(1.0 / n for n in size), 0)
    entry = base.Operator("A", grid, base.ConstantStencilGenerator(stencil))
    A = system.Operator("A", [[entry]])
    u = system.Approximation("u", [base.Approximation("u", grid)])
    f = system.RightHandSide("f", [base.RightHandSide("f", grid)])
    correction = base.Multiplication(
        base.Inverse(smoother.generate_collective_jacobi(A)),
        base.Residual(A, u, f),
    )
    return base.Cycle(u, f, correction, partitioning=part.RedBlack,
                      relaxation_factor=omega)
