"""Autograd through the multigrid solve (``torch.autograd``).

The port of ``emg3d_tpu/diff.py``: its ``jax.custom_vjp`` becomes a
:class:`torch.autograd.Function` whose backward pass is

1. **one adjoint multigrid solve** — the discretized operator A is
   complex-symmetric, so the adjoint system solves the SAME operator
   on the conjugated cotangent (λ = conj(A⁻¹ conj(w))), reusing every
   solver path (the CUDA kernels, semicoarsening, line relaxation,
   Krylov);
2. **the autograd vjp of the residual stencil itself** for the
   parameter pullback: with r(s, e, θ) = s − A(θ)e, the implicit-
   function rule gives ∂φ/∂θ = λᵀ ∂r/∂θ|ₑ — evaluated as
   ``torch.autograd.grad`` of :func:`.ops.stencil.residual_parts` in
   η, ζ at fixed e with ``grad_outputs=λ``, exact for the
   discretization by construction.

Representation: complex tensors instead of the JAX package's split
re/im ``cx.C2`` pairs.  PyTorch's gradient of a real loss L with
respect to a complex tensor z is ∂L/∂Re z + i·∂L/∂Im z, which is the
JAX package's (re, im) gradient pair read as one complex number; ζ is
real and gets a real gradient.  The source's gradient is λ.

Each solve runs on the device of the input tensors (CUDA unless the
caller asks for the CPU), through ``solver.solve`` with host fields:
tensor → ``SourceField`` → solve → ``Field`` → tensor copies each
solve's source and field across the host once each way.  The field
comes back in the source's dtype, as the JAX package's ``_host_solve``
casts it: a complex64 source gives a complex64 field, and its adjoint
solve runs in complex64 too.  With the x64 switch off
(:func:`.dtypes.set_x64`) the cell volumes and widths are float32, as
the JAX package's ``jnp.asarray`` makes them with x64 off.
"""
import numpy as np
import torch
from scipy.constants import mu_0

from . import fields, solver
from .dtypes import precision, real_dtype
from .ops import stencil

__all__ = ['make_differentiable_solve', 'eta_zeta_from_sigma',
           'sample_edges']


class _VShim:
    """VolumeModel stand-in carrying prebuilt η/ζ numpy arrays."""

    def __init__(self, eta_x, eta_y, eta_z, zeta):
        self.eta_x = eta_x
        self.eta_y = eta_y
        self.eta_z = eta_z
        self.zeta = zeta


def eta_zeta_from_sigma(grid, sigma, frequency, mu_r=None):
    """(η, ζ) from an isotropic conductivity tensor (differentiable).

    Mirrors models.VolumeModel for the σ-only case:
    η = s·μ0·V·σ with s = −2πif, ζ = V/μ_r.  Returns η complex and ζ
    real, on σ's device; the volumes are float32 with x64 off.
    """
    vol = torch.tensor(np.asarray(grid.cell_volumes).reshape(
        tuple(grid.shape_cells), order='F'), dtype=_real(),
        device=sigma.device)
    smu0_im = -2 * np.pi * frequency * mu_0
    eta = torch.complex(0.0 * vol * sigma, smu0_im * vol * sigma)
    zeta = vol if mu_r is None else vol / mu_r
    return eta, zeta


def _real():
    """The device real dtype under the x64 switch."""
    return precision(real_dtype())[0]


def sample_edges(e, weights):
    """Differentiable linear sampling of field components.

    ``weights`` is a list of (component, w) pairs with w a real tensor
    shaped like that component (e.g. trilinear receiver weights);
    returns the complex samples, shape (n,).
    """
    return torch.stack([torch.sum(w * e[comp]) for comp, w in weights])


class _Solve(torch.autograd.Function):
    """e = A(η, ζ)⁻¹ s, with the adjoint-solve backward."""

    @staticmethod
    def forward(ctx, run, h, eta_x, eta_y, eta_z, zeta, sx, sy, sz):
        e = run((eta_x, eta_y, eta_z, zeta), (sx, sy, sz))
        ctx.run, ctx.h = run, h
        ctx.save_for_backward(eta_x, eta_y, eta_z, zeta, *e)
        return e

    @staticmethod
    def backward(ctx, *w):
        eta_x, eta_y, eta_z, zeta, *e = ctx.saved_tensors
        a4 = (eta_x, eta_y, eta_z, zeta)
        # Adjoint solve: A complex-symmetric => λ = conj(A⁻¹ conj(w)).
        lam = tuple(torch.conj_physical(c) for c in
                    ctx.run(a4, tuple(c.conj() for c in w)))
        grads = [None] * 4
        need = ctx.needs_input_grad[2:6]
        if any(need):
            # Parameter pullback: λᵀ ∂r/∂θ at fixed e (r = s − A(θ)e).
            with torch.enable_grad():
                leaves = tuple(a.detach().requires_grad_(n)
                               for a, n in zip(a4, need))
                zeros = tuple(torch.zeros_like(c) for c in e)
                r = stencil.residual_parts(*zeros, *e, *leaves, *ctx.h)
                wanted = [x for x, n in zip(leaves, need) if n]
                got = iter(torch.autograd.grad(r, wanted, grad_outputs=lam))
            grads = [next(got) if n else None for n in need]
        return (None, None, *grads, *lam)


def make_differentiable_solve(grid, frequency, device=None, **solver_opts):
    """A differentiable ``fsolve(arrays4, s) -> e`` for this grid.

    arrays4 : (eta_x, eta_y, eta_z, zeta) — η complex cell tensors, ζ
        real; each receives a gradient (η complex, ζ real).
    s : 3-tuple of complex source-field component tensors; receives λ
        as its gradient (the adjoint field — free for source studies).
    device : where the solves run: None means ``'cuda'`` and raises
        when no CUDA device exists; CPU runs ask for ``device='cpu'``.
        The tensors given to ``fsolve`` must lie there.

    The forward and adjoint solves run the full production solver
    with ``solver_opts`` (tol, cycle, sslsolver, semicoarsening,
    linerelaxation, ...).  Gradient accuracy is bounded by the solve
    tolerance; use tol <= 1e-8 for tight FD checks.
    """
    solver_opts.setdefault('verb', 0)
    device = solver._resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    h = tuple(torch.tensor(np.asarray(hh, dtype=np.float64), dtype=_real(),
                           device=device) for hh in grid.h)

    def host(t):
        return t.detach().resolve_conj().cpu().numpy()

    def run(arrays4, s):
        for t in (*arrays4, *s):
            if t.device != device:
                raise ValueError(f"fsolve runs on {device}; got a tensor "
                                 f"on {t.device}")
        ex = host(arrays4[0])
        ey, ez = (ex if t is arrays4[0] else host(t) for t in arrays4[1:3])
        vshim = _VShim(ex, ey, ez, host(arrays4[3]))
        sfield = fields.SourceField(*(host(c) for c in s),
                                    frequency=frequency)
        e, info = solver.solve(grid, None, sfield, _vmodel=vshim,
                               return_info=True, device=device,
                               **solver_opts)
        if info['exit_message'] == 'DIVERGED':
            raise RuntimeError(f"AD inner solve diverged: {info}")
        # In the source's dtype (JAX diff.py:116-121): a two-float
        # solve's complex128 hi + lo comes back as complex64.
        return tuple(torch.tensor(c, dtype=s[0].dtype, device=device)
                     for c in (e.fx, e.fy, e.fz))

    def fsolve(arrays4, s):
        return _Solve.apply(run, h, *arrays4, *s)

    return fsolve
