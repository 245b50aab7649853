"""Batched small complex-symmetric solves (LDLᵀ, no pivoting).

Counterpart of ``emg3d_tpu/ops/blocksolve.py:32-110``, the replacement
of the reference's sequential banded Cholesky (emg3d/core.py:1447-1582):
instead of factorizing one 6×6 node system at a time, millions of them
are factorized at once as unrolled elementwise operations on tensors.

:func:`ldl_solve_sparse` operates on a sparsity-annotated lower
triangle given as per-entry tensors (entries may be ``None`` = zero).
It serves the 6×6 point-smoother blocks, where materializing a dense
(..., 6, 6) tensor would waste memory.  :func:`block_tridiag_factor_entries`
and :func:`block_tridiag_solve_entries` are the sparse-entry 5×5
block-Thomas of line relaxation (JAX module 237-383), with Python loops
over the stations in place of ``lax.scan`` and the same operation
order.  The dense block-Thomas helpers of the JAX module are not
ported (ROADMAP).

The matrices are complex-*symmetric* (A = Aᵀ, not hermitian): the
factorization is A = L D Lᵀ without conjugation, as in [Muld07].  The
CUDA point kernels (``csrc/point_gs.cu``) repeat this arithmetic in
registers, in the same order, and so do the line kernels
(``csrc/line_gs.cu``) for the block-Thomas elimination (K5) and
substitution (K4).
"""
import torch

__all__ = ['ldl_factor_sparse', 'ldl_solve_factored', 'ldl_solve_sparse',
           'block_tridiag_factor_entries', 'block_tridiag_solve_entries']


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


def _lower_keys(n):
    return [(i, j) for i in range(n) for j in range(i)]


def _b_rows(bkeys):
    """Row a -> the columns k of the present entries B[(a, k)]."""
    rows = {}
    for (a, k) in bkeys:
        rows.setdefault(a, []).append(k)
    return rows


def block_tridiag_factor_entries(n, Dent, Bent, out):
    """Sparse-entry block-Thomas elimination (field-independent part).

    ``Dent``/``Bent`` are dicts of ``(S, ...)`` per-entry stacks of the
    diagonal blocks (lower triangle) and the sub-diagonal blocks B_i
    (station i -> i-1; missing = structurally zero).  Eliminates
    C_0 = D_0, C_i = D_i − B_i C_{i-1}⁻¹ B_iᵀ and writes the LDLᵀ
    factors of every C_i, station by station, into ``out``
    ``(S, n(n-1)/2 + n, ...)``: one plane per strict lower entry
    (``_lower_keys(n)`` order, zeros where structurally absent), then
    one per inverse diagonal.  Returns ``(L_all, d_all)``, views of
    ``out``: the factors are never held twice.
    """
    lk = _lower_keys(n)
    S = next(iter(Dent.values())).shape[0]
    dkeys = sorted(Dent.keys())
    bkeys = sorted(Bent.keys())
    brows = _b_rows(bkeys)

    def full_fact(L, dinv):
        zero = 0.0 * dinv[0]
        return [L.get(k, zero) for k in lk], list(dinv)

    def keep(i, fact):
        for p, v in enumerate(fact[0] + fact[1]):
            out[i, p] = v

    prev = full_fact(*ldl_factor_sparse(n, {k: Dent[k][0] for k in dkeys}))
    keep(0, prev)
    for i in range(1, S):
        Ld = dict(zip(lk, prev[0]))
        D = {k: Dent[k][i] for k in dkeys}
        B = {k: Bent[k][i] for k in bkeys}
        # cols[b] = C_{i-1}⁻¹ (row b of B_i)  [= column b of C⁻¹B_iᵀ].
        zero = 0.0 * prev[1][0]
        cols = {}
        for b in brows:
            rhs = [B.get((b, k), zero) for k in range(n)]
            cols[b] = ldl_solve_factored(n, Ld, list(prev[1]), rhs)
        # C_i = D_i − B_i cols  (lower triangle; B row a is sparse).
        C = {}
        for a in range(n):
            for b in range(a + 1):
                acc = D.get((a, b))
                if a in brows and b in cols:
                    for k in brows[a]:
                        t = B[(a, k)] * cols[b][k]
                        acc = (-t) if acc is None else (acc - t)
                if acc is not None:
                    C[(a, b)] = acc
        prev = full_fact(*ldl_factor_sparse(n, C))
        keep(i, prev)
    nl = len(lk)
    return ([out[:, p] for p in range(nl)], [out[:, nl + p] for p in range(n)])


def block_tridiag_solve_entries(n, facts, Bent, r):
    """Solve with :func:`block_tridiag_factor_entries` factors.

    ``r`` is a list of n ``(S, ...)`` tensors; returns the same.  The
    recurrence is the one of the JAX package and of the line kernel:

        z_0 = C_0⁻¹ r_0,  z_i = C_i⁻¹ (r_i − B_i z_{i-1})
        δ_{S-1} = z_{S-1},  δ_i = z_i − C_i⁻¹ (B_{i+1}ᵀ δ_{i+1})
    """
    lk = _lower_keys(n)
    L_all, d_all = facts
    S = r[0].shape[0]
    bkeys = sorted(Bent.keys())
    brows = _b_rows(bkeys)
    bcols = {}                      # column a of Bᵀ <-> entries B[(k, a)]
    for (k, a) in bkeys:
        bcols.setdefault(a, []).append(k)

    def solve_one(i, y):
        return ldl_solve_factored(n, dict(zip(lk, [v[i] for v in L_all])),
                                  [v[i] for v in d_all], y)

    zs = [solve_one(0, [v[0] for v in r])]
    for i in range(1, S):
        zp = zs[-1]
        y = []
        for a in range(n):
            acc = r[a][i]
            for k in brows.get(a, ()):
                acc = acc - Bent[(a, k)][i] * zp[k]
            y.append(acc)
        zs.append(solve_one(i, y))

    ds = [None] * S
    ds[S - 1] = zs[S - 1]
    for i in range(S - 2, -1, -1):
        dn = ds[i + 1]
        u = []
        for a in range(n):
            acc = None
            for k in bcols.get(a, ()):
                t = Bent[(k, a)][i + 1] * dn[k]
                acc = t if acc is None else acc + t
            u.append(acc if acc is not None else 0.0 * zs[i][a])
        cu = solve_one(i, u)
        ds[i] = [z - c for z, c in zip(zs[i], cu)]
    return [torch.stack([d[a] for d in ds]) for a in range(n)]
