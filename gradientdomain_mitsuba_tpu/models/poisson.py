"""Screened-Poisson reconstruction (L2 conjugate gradient, L1 IRLS).

Replacement for the fork's poisson_solver
(src/integrators/poisson_solver/Solver.cpp, OpenMP CPU backend): solves

    min_I  || Dx I - gx ||_p + || Dy I - gy ||_p + alpha^2-screened data term
           alpha * || I - P ||_p ,   p in {1, 2}

per RGB channel fully on-device.  Dx/Dy are forward differences with
Neumann boundaries expressed as padded shifts (XLA fuses the stencils);
CG state lives in [3, H, W] arrays; the L1 mode runs IRLS outer iterations
reweighting all residuals by 1/max(|r|, eps).  At film resolutions this is
small work next to the render — render and reconstruction fuse into one
device program with no host round trip (SURVEY.md §8.1).

Semantics notes (vs the reference):
  - gx[i, j] estimates I[i, j+1] - I[i, j]; the last column/row of gx/gy
    lie outside the lattice and are masked out.
  - L2 solves (Dx^T Dx + Dy^T Dy + alpha^2) I = Dx^T gx + Dy^T gy +
    alpha^2 P — linear in the inputs, so E[solution] is the solution of
    the expected inputs: reconstruction preserves unbiasedness.
  - The very-direct buffer is added AFTER the solve by the caller
    (gpt.cpp behavior).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _dx(img):
    """Forward difference along x (last column -> 0)."""
    d = img[..., :, 1:] - img[..., :, :-1]
    return jnp.pad(d, [(0, 0)] * (img.ndim - 1) + [(0, 1)])


def _dy(img):
    d = img[..., 1:, :] - img[..., :-1, :]
    return jnp.pad(d, [(0, 0)] * (img.ndim - 2) + [(0, 1), (0, 0)])


def _dxT(g):
    """Adjoint of _dx (negative divergence component)."""
    return (jnp.pad(g[..., :, :-1], [(0, 0)] * (g.ndim - 1) + [(1, 0)])
            - jnp.pad(g[..., :, :-1], [(0, 0)] * (g.ndim - 1) + [(0, 1)]))


def _dyT(g):
    return (jnp.pad(g[..., :-1, :], [(0, 0)] * (g.ndim - 2) + [(1, 0),
                                                               (0, 0)])
            - jnp.pad(g[..., :-1, :], [(0, 0)] * (g.ndim - 2) + [(0, 1),
                                                                 (0, 0)]))


def _mask_gradients(gx, gy):
    """Zero the out-of-lattice last column of gx / last row of gy."""
    gx = gx.at[..., :, -1].set(0.0)
    gy = gy.at[..., -1, :].set(0.0)
    return gx, gy


def _cg(A, b, x0, iters, tol=1e-7):
    """Batched conjugate gradient over leading axes (channels).  Returns
    (x, residual_norms [iters]) — the per-iteration L2 residual curve is
    the solver observability the reference's Solver.cpp prints per sweep
    (SURVEY.md §6.5; surfaced via reconstruct(..., return_stats=True))."""
    def dot(a, c):
        return jnp.sum(a * c, axis=(-2, -1), keepdims=True)

    r = b - A(x0)
    p = r
    rs = dot(r, r)
    res = jnp.zeros(iters)

    def body(i, st):
        x, r, p, rs, res = st
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = jnp.where(rs > 0, rs_new / jnp.maximum(rs, 1e-30), 0.0)
        p = r + beta * p
        res = res.at[i].set(jnp.sqrt(jnp.sum(rs_new)))
        return x, r, p, rs_new, res

    x, r, p, rs, res = jax.lax.fori_loop(0, iters, body,
                                         (x0, r, p, rs, res))
    return x, res


@functools.partial(jax.jit, static_argnames=("iters", "return_residuals"))
def solve_l2(primal, gx, gy, alpha=0.2, iters=100, return_residuals=False):
    """L2 screened-Poisson solve. All inputs [H, W, 3]; returns [H, W, 3]
    (plus the CG residual curve when return_residuals)."""
    P = jnp.moveaxis(primal, -1, 0)  # [3, H, W]
    GX = jnp.moveaxis(gx, -1, 0)
    GY = jnp.moveaxis(gy, -1, 0)
    GX, GY = _mask_gradients(GX, GY)
    a2 = alpha * alpha

    def A(x):
        return _dxT(_dx(x)) + _dyT(_dy(x)) + a2 * x

    b = _dxT(GX) + _dyT(GY) + a2 * P
    x, res = _cg(A, b, P, iters)
    out = jnp.moveaxis(x, 0, -1)
    return (out, res) if return_residuals else out


@functools.partial(jax.jit,
                   static_argnames=("outer_iters", "inner_iters",
                                    "return_residuals"))
def solve_l1(primal, gx, gy, alpha=0.2, outer_iters=8, inner_iters=40,
             irls_eps=1e-4, return_residuals=False):
    """L1 reconstruction via IRLS: reweighted L2 solves (Solver.cpp L1 mode,
    `reconstructL1=true` default in gpt.cpp)."""
    P = jnp.moveaxis(primal, -1, 0)
    GX = jnp.moveaxis(gx, -1, 0)
    GY = jnp.moveaxis(gy, -1, 0)
    GX, GY = _mask_gradients(GX, GY)
    a2 = alpha * alpha

    def outer(i, carry):
        x, res_all = carry
        rx = _dx(x) - GX
        ry = _dy(x) - GY
        rp = x - P
        wx = 1.0 / jnp.maximum(jnp.abs(rx), irls_eps)
        wy = 1.0 / jnp.maximum(jnp.abs(ry), irls_eps)
        wp = 1.0 / jnp.maximum(jnp.abs(rp), irls_eps)

        def A(v):
            return (_dxT(wx * _dx(v)) + _dyT(wy * _dy(v)) + a2 * wp * v)

        b = _dxT(wx * GX) + _dyT(wy * GY) + a2 * wp * P
        x, res = _cg(A, b, x, inner_iters)
        return x, res_all.at[i].set(res)

    x, res_all = jax.lax.fori_loop(
        0, outer_iters, outer,
        (P, jnp.zeros((outer_iters, inner_iters))))
    out = jnp.moveaxis(x, 0, -1)
    return (out, res_all.reshape(-1)) if return_residuals else out


def reconstruct(buffers, alpha=0.2, mode="L1", l2_iters=100,
                l1_outer=8, l1_inner=40, return_stats=False):
    """Full gpt/gbdpt post-pass: solve + re-add very direct.

    buffers: dict with primal/dx/dy/very_direct [H, W, 3] (sample-normalized
    as produced by GPTracer.render).  Returns the final image, or
    (final, {"cg_residuals": [iters]}) with return_stats."""
    primal = jnp.asarray(buffers["primal"])
    gx = jnp.asarray(buffers["dx"])
    gy = jnp.asarray(buffers["dy"])
    if mode.upper() == "L2":
        out = solve_l2(primal, gx, gy, alpha=alpha, iters=l2_iters,
                       return_residuals=return_stats)
    else:
        out = solve_l1(primal, gx, gy, alpha=alpha, outer_iters=l1_outer,
                       inner_iters=l1_inner, return_residuals=return_stats)
    if return_stats:
        rec, res = out
        final = rec + jnp.asarray(buffers["very_direct"])
        import numpy as np
        return final, {"cg_residuals": np.asarray(res)}
    return out + jnp.asarray(buffers["very_direct"])
