"""GELU through clamped minimax polynomials: the fused kernels' GELU.

Port of ``coral_tpu/ops/gelu_dropout_pallas.py`` (``_odd_poly``, ``_phi``,
``_dgelu``, ``_gelu_parts``, ``gelu_poly``). Phi(x) and gelu'(x) are
evaluated as ``0.5 + xc * P(t)`` with ``xc = clamp(x, -B, B)`` and
``t = 2 xc^2 / B^2 - 1``. This is not erf: it is what the JAX kernels and the
port's CUDA kernels (``csrc/gelu_poly.cuh``) compute, so the packages agree.

The table set is read once at import from ``CORAL_GELU_POLY`` (``short``, the
default, or ``f32``; anything else raises), exactly as the JAX package reads
it, so both packages pick the same tables. The kernel build passes the choice
to ``nvcc``.
"""

from __future__ import annotations

import os

import torch

_PHI_B_F32 = 5.0
_PHI_COEF_F32 = (
    6.087279384e-04, -1.613265746e-03, 1.722797782e-03, -2.685573600e-03,
    6.410511945e-03, -1.116434054e-02, 1.640217381e-02, -2.326865223e-02,
    3.144217246e-02, -4.044260744e-02, 5.152052231e-02, -7.029628062e-02,
    1.413637876e-01,
)
_DGELU_B_F32 = 6.0
_DGELU_COEF_F32 = (
    1.160769890e-02, -2.627453446e-02, 2.958332316e-03, 1.345187901e-02,
    3.941384738e-02, -7.720006826e-02, 5.279141289e-02, -4.532931027e-02,
    6.637700848e-02, -7.008341803e-02, 5.899570471e-02, -5.007458583e-02,
    4.450609891e-02, -4.242304905e-02, 4.606032178e-02, -5.934169541e-02,
    1.178977407e-01,
)
_PHI_B_SHORT = 4.0
_PHI_COEF_SHORT = (
    5.972141034e-03, -1.655117714e-02, 2.409117135e-02, -3.546221027e-02,
    5.541011030e-02, -8.442662317e-02, 1.759702204e-01,
)
_DGELU_B_SHORT = 4.5
_DGELU_COEF_SHORT = (
    4.661251130e-02, -9.640384027e-02, 6.408569320e-02, -5.309721980e-02,
    9.629088892e-02, -1.040159096e-01, 8.764104305e-02, -8.934778768e-02,
    1.594094857e-01,
)

GELU_POLY_CHOICE = os.environ.get("CORAL_GELU_POLY", "short")
if GELU_POLY_CHOICE == "f32":
    _PHI_B, _PHI_COEF = _PHI_B_F32, _PHI_COEF_F32
    _DGELU_B, _DGELU_COEF = _DGELU_B_F32, _DGELU_COEF_F32
elif GELU_POLY_CHOICE == "short":
    _PHI_B, _PHI_COEF = _PHI_B_SHORT, _PHI_COEF_SHORT
    _DGELU_B, _DGELU_COEF = _DGELU_B_SHORT, _DGELU_COEF_SHORT
else:
    raise ValueError(
        f"CORAL_GELU_POLY={GELU_POLY_CHOICE!r}: expected 'short' or 'f32'"
    )


def _odd_poly(x: torch.Tensor, coef, bound: float) -> torch.Tensor:
    xc = torch.clamp(x, -bound, bound)
    t = (2.0 / (bound * bound)) * (xc * xc) - 1.0
    acc = torch.full_like(t, coef[0])
    for c in coef[1:]:
        acc = acc * t + c
    return 0.5 + xc * acc


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) = 0.5 (1 + erf(x / sqrt(2))), in the dtype of ``x``."""
    return _odd_poly(x, _PHI_COEF, _PHI_B)


def _dgelu(x: torch.Tensor) -> torch.Tensor:
    """gelu'(x) = Phi(x) + x phi(x), one polynomial."""
    return _odd_poly(x, _DGELU_COEF, _DGELU_B)


def _gelu_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gelu(x), Phi(x))."""
    phi_cdf = _phi(x)
    return x * phi_cdf, phi_cdf


class _GeluPoly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _phi(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return _dgelu(x) * dy


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU with the selected tables: forward ``x * _phi(x)``, derivative
    ``_dgelu(x)`` (the dedicated fit, not the derivative of the forward fit),
    as the JAX ``gelu_poly`` custom JVP defines it."""
    return _GeluPoly.apply(x)
