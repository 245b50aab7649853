"""Batched small complex-symmetric solves (LDLᵀ, no pivoting).

Counterpart of ``emg3d_tpu/ops/blocksolve.py:32-110``, the replacement
of the reference's sequential banded Cholesky (emg3d/core.py:1447-1582):
instead of factorizing one 6×6 node system at a time, millions of them
are factorized at once as unrolled elementwise operations on tensors.

:func:`ldl_solve_sparse` operates on a sparsity-annotated lower
triangle given as per-entry tensors (entries may be ``None`` = zero).
It serves the 6×6 point-smoother blocks, where materializing a dense
(..., 6, 6) tensor would waste memory.  The dense block-Thomas helpers
of the JAX module belong to the line-relaxation slice of the port.

The matrices are complex-*symmetric* (A = Aᵀ, not hermitian): the
factorization is A = L D Lᵀ without conjugation, as in [Muld07].  The
CUDA point kernels (``csrc/point_gs.cu``) repeat this arithmetic in
registers, in the same order.
"""
__all__ = ['ldl_factor_sparse', 'ldl_solve_factored', 'ldl_solve_sparse']


def ldl_factor_sparse(n, entries):
    """Factorize complex-symmetric sparse-lower A = L D Lᵀ.

    The factorization depends only on the model coefficients (not on
    the field), so callers hoist it out of the per-color sweep.

    Returns (L, dinv): dict of strict-lower entries, list of inverse
    diagonal entries.
    """
    L = {}
    dinv = [None] * n
    for j in range(n):
        acc = entries.get((j, j))
        if acc is None:
            raise ValueError(f"Diagonal entry ({j},{j}) must be present.")
        for k in range(j):
            Ljk = L.get((j, k))
            if Ljk is not None:
                acc = acc - Ljk * Ljk * _d(dinv, k)
        dinv[j] = 1.0 / acc
        for i in range(j + 1, n):
            a = entries.get((i, j))
            s = None
            for k in range(j):
                Lik = L.get((i, k))
                Ljk = L.get((j, k))
                if Lik is not None and Ljk is not None:
                    t = Lik * Ljk * _d(dinv, k)
                    s = t if s is None else s + t
            if a is None and s is None:
                continue
            val = (a if a is not None else 0.)
            if s is not None:
                val = val - s
            L[(i, j)] = val * dinv[j]
    return L, dinv


def ldl_solve_factored(n, L, dinv, b):
    """Solve with a factorization from :func:`ldl_factor_sparse`."""
    y = list(b)
    for i in range(n):
        for k in range(i):
            Lik = L.get((i, k))
            if Lik is not None:
                y[i] = y[i] - Lik * y[k]
    for i in range(n):
        y[i] = y[i] * dinv[i]
    for i in range(n - 2, -1, -1):
        for k in range(i + 1, n):
            Lki = L.get((k, i))
            if Lki is not None:
                y[i] = y[i] - Lki * y[k]
    return y


def ldl_solve_sparse(n, entries, b):
    """Solve A x = b for complex-symmetric A given as sparse lower entries.

    Parameters
    ----------
    n : int
        System size (static).
    entries : dict[(i, j)] -> array or None
        Lower-triangle entries (i >= j), broadcast-compatible arrays;
        missing/None entries are structurally zero.
    b : list of n arrays
        Right-hand side components.

    Returns
    -------
    list of n arrays — the solution components.
    """
    L, dinv = ldl_factor_sparse(n, entries)
    return ldl_solve_factored(n, L, dinv, b)


def _d(dinv, k):
    return 1.0 / dinv[k]
