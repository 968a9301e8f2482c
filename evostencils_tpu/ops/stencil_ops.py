"""Core stencil application kernels (JAX/XLA).

Grid functions are dense jnp arrays over the *interior* nodes of a
structured grid with homogeneous Dirichlet boundaries; boundary values are
folded into the right-hand side at problem setup.  A constant stencil
application is a sum of shifted loads of the zero-padded field — XLA fuses
the whole sum into a single loop, one read of the field and one write,
for the 5/7/9-point stencils that dominate multigrid.  Residual and
smoother update fuse the same way (ops/smoothers.py, backend/lowering.py).

Replaces the external generated-C++ stencil loops of the reference
(SURVEY.md §2.2; reference code_generation/exastencils.py:684-925 emitted
ExaSlang which ExaStencils turned into OpenMP C++).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from evostencils_tpu.stencils import constant, periodic


def _is_zero_offset(offset) -> bool:
    return all(o == 0 for o in offset)


def pad_zeros(u: jax.Array, reach: Tuple[int, ...]) -> jax.Array:
    """Zero-pad by the stencil reach (homogeneous Dirichlet halo)."""
    if all(r == 0 for r in reach):
        return u
    return jnp.pad(u, [(r, r) for r in reach])


def shifted_view(padded: jax.Array, offset, reach, shape) -> jax.Array:
    index = tuple(
        slice(r + o, r + o + n) for r, o, n in zip(reach, offset, shape)
    )
    return padded[index]


def apply_constant_stencil(u: jax.Array, stencil: constant.Stencil) -> jax.Array:
    """y[x] = Σ_o v_o · u[x+o], u extended by zero outside the interior."""
    if stencil.number_of_entries == 0:
        return jnp.zeros_like(u)
    reach = stencil.max_reach()
    padded = pad_zeros(u, reach)
    shape = u.shape
    out = None
    for offset, value in stencil.entries:
        term = value * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


def apply_variable_stencil(
    u: jax.Array, offsets: Sequence[Tuple[int, ...]], planes: Sequence[jax.Array]
) -> jax.Array:
    """Variable-coefficient stencil: one coefficient plane per offset."""
    reach = tuple(
        max(abs(o[a]) for o in offsets) for a in range(len(offsets[0]))
    )
    padded = pad_zeros(u, reach)
    shape = u.shape
    out = None
    for offset, plane in zip(offsets, planes):
        term = plane * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


def parity_masks(shape: Tuple[int, ...], period: Tuple[int, ...], dtype=jnp.float32):
    """All per-cell masks of a period lattice, as a dict index->mask array.

    Index arithmetic is done on *local interior* coordinates; for the
    checkerboard (period 2^d) this matches the reference's global
    `(i0+i1+...)%2` coloring up to a global color swap, which affects
    neither the convergence factor nor the sweep semantics.
    """
    dim = len(shape)
    grids = [np.arange(n) % p for n, p in zip(shape, period)]
    mesh = np.meshgrid(*grids, indexing="ij")
    masks = {}
    for index in np.ndindex(*period):
        m = np.ones(shape, dtype=bool)
        for axis in range(dim):
            m &= mesh[axis] == index[axis]
        masks[index] = jnp.asarray(m.astype(np.dtype(dtype) if dtype != jnp.bool_ else np.bool_))
    return masks


def red_black_masks(shape: Tuple[int, ...], dtype=jnp.float32):
    """(red, black) checkerboard masks: red = even local index sum."""
    grids = [np.arange(n) for n in shape]
    mesh = np.meshgrid(*grids, indexing="ij")
    s = sum(mesh) % 2
    red = jnp.asarray((s == 0).astype(np.float32)).astype(dtype)
    return red, 1.0 - red


def apply_periodic_stencil(u: jax.Array, stencil: periodic.PeriodicStencil) -> jax.Array:
    """Apply a block-varying stencil by masked superposition of its cells."""
    if stencil.is_uniform():
        return apply_constant_stencil(u, stencil.as_constant())
    masks = parity_masks(u.shape, stencil.period, dtype=u.dtype)
    out = jnp.zeros_like(u)
    for index in np.ndindex(*stencil.period):
        cell = stencil.cells[index]
        if cell is None or cell.number_of_entries == 0:
            continue
        out = out + masks[index] * apply_constant_stencil(u, cell)
    return out


def apply_stencil(u: jax.Array, stencil) -> jax.Array:
    if isinstance(stencil, constant.Stencil):
        return apply_constant_stencil(u, stencil)
    if isinstance(stencil, periodic.PeriodicStencil):
        return apply_periodic_stencil(u, stencil)
    raise TypeError(f"Not a stencil: {type(stencil)}")


def numpy_apply_constant_stencil(u: np.ndarray, stencil: constant.Stencil) -> np.ndarray:
    """Float64 host-side stencil application (numpy mirror of
    apply_constant_stencil).  Used by the evaluation harness to compute
    exact residuals at restart boundaries where the device runs f32."""
    if stencil.number_of_entries == 0:
        return np.zeros_like(u)
    reach = stencil.max_reach()
    padded = np.pad(u, [(r, r) for r in reach])
    shape = u.shape
    out = np.zeros_like(u)
    for offset, value in stencil.entries:
        index = tuple(
            slice(r + o, r + o + n) for r, o, n in zip(reach, offset, shape)
        )
        out += value * padded[index]
    return out


def l2_norm(fields: Sequence[jax.Array]) -> jax.Array:
    """Euclidean norm over all fields of a system state."""
    acc = None
    for f in fields:
        s = jnp.sum(jnp.real(f * jnp.conj(f))) if jnp.iscomplexobj(f) else jnp.sum(f * f)
        acc = s if acc is None else acc + s
    return jnp.sqrt(acc)


def dot(a: Sequence[jax.Array], b: Sequence[jax.Array]) -> jax.Array:
    acc = None
    for x, y in zip(a, b):
        s = jnp.sum(jnp.conj(x) * y) if jnp.iscomplexobj(x) else jnp.sum(x * y)
        acc = s if acc is None else acc + s
    return acc


def tree_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def tree_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def tree_scale(factor, a):
    return tuple(factor * x for x in a)


def zeros_like_state(state):
    return tuple(jnp.zeros_like(x) for x in state)
