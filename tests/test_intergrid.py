"""Intergrid transfers (strided-slice stencil form, ops/intergrid.py) against
the plain float64 numpy reference (ops/reference.py), for the separable
defaults, non-separable, 3D, complex, injection and asymmetric stencils.

The test names predate the removal of the dense-matrix and convolution
paths; each now checks the one kept path against the reference."""

import jax.numpy as jnp
import numpy as np
import pytest

import evostencils_tpu.ops.intergrid as ig
from evostencils_tpu.ops import reference as ref
from evostencils_tpu.stencils import constant


@pytest.fixture
def nprng():
    return np.random.default_rng(1234)


def check_restrict(fine, stencil, coarse_shape, coarsening):
    got = ig.restrict(jnp.asarray(fine), stencil, coarse_shape, coarsening)
    want = ref.restrict(fine, stencil.entries, coarse_shape, coarsening)
    assert got.shape == tuple(coarse_shape)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def check_prolong(coarse, stencil, fine_shape, coarsening):
    got = ig.prolong(jnp.asarray(coarse), stencil, fine_shape, coarsening)
    want = ref.prolong(coarse, stencil.entries, fine_shape, coarsening)
    assert got.shape == tuple(fine_shape)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


FW2 = constant.Stencil(
    [((i, j), (2 - abs(i)) * (2 - abs(j)) / 16.0)
     for i in (-1, 0, 1) for j in (-1, 0, 1)]
)
BL2 = constant.Stencil(
    [((i, j), (2 - abs(i)) * (2 - abs(j)) / 4.0)
     for i in (-1, 0, 1) for j in (-1, 0, 1)]
)
# Plus-shaped restriction: rank 2, not separable.
PLUS = constant.Stencil(
    [((0, 0), 0.5), ((1, 0), 0.125), ((-1, 0), 0.125),
     ((0, 1), 0.125), ((0, -1), 0.125)]
)


@pytest.mark.parametrize("level", [3, 4, 5])
def test_separable_matmul_matches_slices_2d(level, nprng):
    nf, nc = 2 ** level - 1, 2 ** (level - 1) - 1
    check_restrict(nprng.standard_normal((nf, nf)), FW2, (nc, nc), (2, 2))
    check_prolong(nprng.standard_normal((nc, nc)), BL2, (nf, nf), (2, 2))


def test_nonseparable_conv_matches_slices(nprng):
    check_restrict(nprng.standard_normal((15, 15)), PLUS, (7, 7), (2, 2))
    check_prolong(nprng.standard_normal((7, 7)), PLUS, (15, 15), (2, 2))


def test_3d_separable(nprng):
    fw3 = constant.Stencil(
        [((i, j, k), (2 - abs(i)) * (2 - abs(j)) * (2 - abs(k)) / 64.0)
         for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    )
    bl3 = constant.Stencil(
        [((i, j, k), (2 - abs(i)) * (2 - abs(j)) * (2 - abs(k)) / 8.0)
         for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    )
    check_restrict(nprng.standard_normal((15,) * 3), fw3, (7,) * 3, (2, 2, 2))
    check_prolong(nprng.standard_normal((7,) * 3), bl3, (15,) * 3, (2, 2, 2))


def test_complex_separable(nprng):
    fine = nprng.standard_normal((15, 15)) + 1j * nprng.standard_normal((15, 15))
    check_restrict(fine, FW2, (7, 7), (2, 2))
    coarse = nprng.standard_normal((7, 7)) + 1j * nprng.standard_normal((7, 7))
    check_prolong(coarse, BL2, (15, 15), (2, 2))


def test_injection(nprng):
    inj = constant.Stencil([((0, 0), 1.0)])
    fine = nprng.standard_normal((15, 15))
    check_restrict(fine, inj, (7, 7), (2, 2))
    np.testing.assert_array_equal(
        np.asarray(ig.restrict(jnp.asarray(fine), inj, (7, 7), (2, 2))),
        fine[1::2, 1::2],
    )


def test_asymmetric_separable(nprng):
    """Evolved/CMA-ES transfers need not be symmetric."""
    a = np.array([0.3, 0.5, 0.2])
    b = np.array([0.1, 0.7, 0.4])
    st = constant.Stencil(
        [((i, j), float(a[i + 1] * b[j + 1]))
         for i in (-1, 0, 1) for j in (-1, 0, 1)]
    )
    check_restrict(nprng.standard_normal((15, 15)), st, (7, 7), (2, 2))
    check_prolong(nprng.standard_normal((7, 7)), st, (15, 15), (2, 2))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex128])
def test_prolong_lowers_without_scatter(dtype):
    """Injection is a padded copy, not a scatter: XLA's GPU backend turns a
    complex128 scatter into a serial loop over the coarse points."""
    import jax

    coarse = jnp.zeros((7, 7), dtype)
    hlo = jax.jit(lambda c: ig.prolong(c, BL2, (15, 15), (2, 2))).lower(coarse).as_text()
    assert "scatter" not in hlo
    got = ig.inject_to_fine(jnp.arange(1, 50, dtype=dtype).reshape(7, 7), (15, 15), (2, 2))
    want = np.zeros((15, 15), dtype)
    want[1::2, 1::2] = np.arange(1, 50).reshape(7, 7)
    np.testing.assert_array_equal(np.asarray(got), want)
