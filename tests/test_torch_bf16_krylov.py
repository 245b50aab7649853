"""Port vs JAX package: a complex64 Krylov solve with bfloat16 storage.

(d) of tests/test_torch_bf16_solve.py for 8³ sc+lr under BiCGSTAB, in a
file of its own (the JAX package's compile of its refined Krylov path
would hold one worker beyond 90 s beside the other solves): every
preconditioner application stores its smoothers' streams in bfloat16,
and every line-factor stack is bfloat16 (threshold 0).
"""
import pytest

pytest.importorskip('jax')

from test_torch_bf16_solve import SCLR, check_solve  # noqa: E402


def test_bicgstab_bf16_matches_jax(monkeypatch):
    check_solve(monkeypatch, 8, dict(SCLR, sslsolver='bicgstab'), True)
