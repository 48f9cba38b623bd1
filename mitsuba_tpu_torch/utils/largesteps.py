"""'Large Steps in Inverse Rendering' mesh preconditioner
(mitsuba_tpu/utils/largesteps.py; reference
src/python/python/ad/largesteps.py).

Vertices are optimised in the differential parameterisation
u = (I + lambda L) v (L the uniform graph Laplacian), so a gradient step
spreads smoothly over the surface.  As in the JAX package, the solve
back to v is conjugate gradients on a matrix-free Laplacian product,
with
``jax.scipy.sparse.linalg.cg``'s stopping rule; its gradient solves the
same symmetric system for the incoming gradient (the JAX package's
implicit CG gradient), not autograd through the iterations.  The
product gathers each vertex's neighbours from a padded table and adds
them in a fixed order, where the JAX package scatters over the edges:
an ``index_add`` adds in a different order on each run on the card, and
the solve, the vertices and the image then part between runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class _Solve(torch.autograd.Function):
    """v = (I + lambda L)^-1 u by CG; the system is symmetric, so the
    backward is the same solve of the incoming gradient."""

    @staticmethod
    def forward(ctx, u, ls, tol, maxiter):
        ctx.args = (ls, tol, maxiter)
        return ls._cg(u, tol, maxiter)

    @staticmethod
    def backward(ctx, grad):
        ls, tol, maxiter = ctx.args
        return ls._cg(grad, tol, maxiter), None, None, None


class LargeSteps:
    """Differential mesh parameterisation (largesteps.py:6 LargeSteps) of
    a mesh of ``vertices`` (V, 3) and ``faces`` (F, 3), on ``device``
    (default: the GPU, raising without one; pass ``device="cpu"`` for
    the CPU).  ``iterations`` holds the CG iterations of the last
    solve."""

    def __init__(self, vertices, faces, lambda_: float = 19.0, device=None):
        self.device = resolve_device(device)
        faces = np.asarray(torch.as_tensor(faces).cpu(), np.int64)
        n = int(vertices.shape[0])
        # unique undirected edges
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        deg = np.zeros(n, np.float32)
        np.add.at(deg, e[:, 0], 1.0)
        np.add.at(deg, e[:, 1], 1.0)
        self.n_verts = n
        self.lambda_ = float(lambda_)
        self.n_edges = len(e)
        self.degree = torch.as_tensor(deg, device=self.device)
        # each vertex's neighbours, padded with n (a zero row): the
        # adjacency product as a gather and a fixed-order sum, the same
        # bits on every run, where index_add's atomics on the card add in
        # another order each time.  The order is the edge scatter's on
        # the CPU: the neighbours above the vertex, then those below,
        # each ascending
        both = np.concatenate([e, e[:, ::-1]])
        both = both[np.lexsort((both[:, 1], both[:, 1] < both[:, 0],
                                both[:, 0]))]
        counts = np.bincount(both[:, 0], minlength=n)
        slot = np.arange(len(both)) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
        nbr = np.full((n, max(int(counts.max(initial=0)), 1)), n, np.int64)
        nbr[both[:, 0], slot] = both[:, 1]
        self.neighbours = torch.as_tensor(nbr, device=self.device)
        self.iterations = 0

    def _as_f32(self, x):
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def _laplacian_matvec(self, x):
        """(I + lambda L) x with the uniform Laplacian L = D - A, A x
        summed over each vertex's neighbours in a fixed order."""
        g = torch.cat([x, torch.zeros_like(x[:1])])[self.neighbours]
        ax = g[:, 0]
        for k in range(1, g.shape[1]):
            ax = ax + g[:, k]
        return x + self.lambda_ * (self.degree[:, None] * x - ax)

    def _cg(self, b, tol, maxiter):
        """CG from x = 0 until ||r||^2 <= tol^2 ||b||^2 or ``maxiter``
        iterations (jax.scipy.sparse.linalg.cg with atol 0)."""
        with torch.no_grad():
            x = torch.zeros_like(b)
            r = b - self._laplacian_matvec(x)
            p = r
            gamma = torch.sum(r * r)
            atol2 = torch.square(torch.tensor(
                tol, dtype=torch.float32, device=b.device)) * torch.sum(b * b)
            k = 0
            while k < maxiter and bool(gamma > atol2):
                ap = self._laplacian_matvec(p)
                alpha = gamma / torch.sum(p * ap)
                x = x + alpha * p
                r = r - alpha * ap
                gamma_next = torch.sum(r * r)
                p = r + (gamma_next / gamma) * p
                gamma = gamma_next
                k += 1
        self.iterations = k
        return x

    def to_differential(self, verts):
        """v -> u = (I + lambda L) v (largesteps.py to_differential)."""
        return self._laplacian_matvec(self._as_f32(verts))

    def from_differential(self, u, tol: float = 1e-6, maxiter: int = 200):
        """u -> v: the CG solve of (I + lambda L) v = u
        (largesteps.py from_differential), differentiable in ``u``."""
        return _Solve.apply(self._as_f32(u), self, tol, maxiter)
