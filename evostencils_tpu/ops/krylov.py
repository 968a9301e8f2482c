"""Krylov-subspace solvers over system states (tuples of grid fields).

Each solver takes a matrix-free `apply_a(state) -> state` closure and runs
a *static* number of iterations inside `lax.fori_loop`, so the whole solve
compiles into one XLA computation with no dynamic shapes — the JAX-native
replacement for the reference's ExaSlang-generated CG/BiCGStab/MinRes/CR
coarse- and outer-solvers (reference ir/krylov_subspace.py:32-45,
code_generation/exastencils.py:1025-1101).

`preconditioned_bicgstab` additionally accepts an `apply_m` preconditioner
closure — the evolved-multigrid-preconditioner driver used by the
Helmholtz configuration (example_problems/Helmholtz PreconditionedBiCGStab).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from evostencils_tpu.ops.stencil_ops import dot, tree_add, tree_scale, tree_sub, zeros_like_state

State = Sequence[jax.Array]
_EPS = 1e-30


def _safe_div(a, b):
    return a / jnp.where(jnp.abs(b) < _EPS, jnp.asarray(_EPS, dtype=b.dtype), b)


def conjugate_gradient(apply_a: Callable, rhs: State, iterations: int, x0: State | None = None) -> State:
    x = zeros_like_state(rhs) if x0 is None else x0
    r = tree_sub(rhs, apply_a(x)) if x0 is not None else rhs
    p = r
    rr = dot(r, r)

    def body(_, carry):
        x, r, p, rr = carry
        ap = apply_a(p)
        alpha = _safe_div(rr, dot(p, ap))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        rr_new = dot(r, r)
        beta = _safe_div(rr_new, rr)
        p = tree_add(r, tree_scale(beta, p))
        return x, r, p, rr_new

    x, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, r, p, rr))
    return x


def conjugate_residual(apply_a: Callable, rhs: State, iterations: int) -> State:
    x = zeros_like_state(rhs)
    r = rhs
    p = r
    ar = apply_a(r)
    ap = ar
    rar = dot(r, ar)

    def body(_, carry):
        x, r, p, ap, rar = carry
        alpha = _safe_div(rar, dot(ap, ap))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        ar = apply_a(r)
        rar_new = dot(r, ar)
        beta = _safe_div(rar_new, rar)
        p = tree_add(r, tree_scale(beta, p))
        ap = tree_add(ar, tree_scale(beta, ap))
        return x, r, p, ap, rar_new

    x, _, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, r, p, ap, rar))
    return x


def minres(apply_a: Callable, rhs: State, iterations: int) -> State:
    """MinRes via the conjugate-residual recurrence (symmetric A)."""
    return conjugate_residual(apply_a, rhs, iterations)


def bicgstab(apply_a: Callable, rhs: State, iterations: int) -> State:
    x = zeros_like_state(rhs)
    r = rhs
    r_hat = r
    p = r
    rho = dot(r_hat, r)

    def body(_, carry):
        x, r, p, rho = carry
        v = apply_a(p)
        alpha = _safe_div(rho, dot(r_hat, v))
        s = tree_sub(r, tree_scale(alpha, v))
        t = apply_a(s)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = tree_add(x, tree_add(tree_scale(alpha, p), tree_scale(omega, s)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = dot(r_hat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, v))))
        return x, r, p, rho_new

    x, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, r, p, rho))
    return x


def preconditioned_bicgstab(
    apply_a: Callable,
    apply_m: Callable,
    rhs: State,
    max_iterations: int,
    target_reduction: float,
) -> tuple:
    """Right-preconditioned BiCGStab; returns (x, iterations, final_res_norm).

    `apply_m(state)` applies the (evolved multigrid) preconditioner — one or
    more cycles approximating M^{-1}.  Runs in a while_loop with a residual
    stopping test, mirroring the hand-written Helmholtz driver.
    """
    x = zeros_like_state(rhs)
    r = rhs
    r_hat = r
    p = r
    rho = dot(r_hat, r)
    res0 = jnp.sqrt(jnp.real(dot(r, r)))

    # Breakdown safety (finite-precision BiCGStab: ρ or ω can collapse,
    # poisoning the recurrence with NaN): the loop exits on any
    # non-finite residual and the carry keeps the best-so-far iterate, so
    # the restarted outer driver (backend/evaluation.py) can continue
    # from the last good state instead of losing the whole stage.
    def cond(carry):
        _, r, _, _, it, _, _ = carry
        res = jnp.sqrt(jnp.real(dot(r, r)))
        return jnp.logical_and(
            jnp.logical_and(it < max_iterations, res > target_reduction * res0),
            jnp.isfinite(res),
        )

    def body(carry):
        x, r, p, rho, it, best_x, best_res = carry
        p_hat = apply_m(p)
        v = apply_a(p_hat)
        alpha = _safe_div(rho, dot(r_hat, v))
        s = tree_sub(r, tree_scale(alpha, v))
        s_hat = apply_m(s)
        t = apply_a(s_hat)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = tree_add(x, tree_add(tree_scale(alpha, p_hat), tree_scale(omega, s_hat)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = dot(r_hat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, v))))
        res = jnp.sqrt(jnp.real(dot(r, r)))
        improved = jnp.logical_and(jnp.isfinite(res), res < best_res)
        best_x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x, best_x
        )
        best_res = jnp.where(improved, res, best_res)
        return x, r, p, rho_new, it + 1, best_x, best_res

    x, r, _, _, it, best_x, best_res = jax.lax.while_loop(
        cond, body, (x, r, p, rho, jnp.asarray(0), x, res0)
    )
    res = jnp.sqrt(jnp.real(dot(r, r)))
    use_last = jnp.logical_and(jnp.isfinite(res), res <= best_res)
    x = jax.tree_util.tree_map(
        lambda last, best: jnp.where(use_last, last, best), x, best_x
    )
    return x, it, jnp.minimum(jnp.where(jnp.isfinite(res), res, best_res), best_res)


SOLVERS = {
    "ConjugateGradient": conjugate_gradient,
    "BiCGStab": bicgstab,
    "MinRes": minres,
    "ConjugateResidual": conjugate_residual,
}
