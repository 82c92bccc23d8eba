"""ADMM gain-design parameters (the port's own copy of the reference's
`AdmmParams`, `aclswarm_tpu/gains/reference.py`; mirror of `admm::Params`,
`lib/admm/include/admm/solver.h:18-31`)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdmmParams:
    """Every field and default of the reference's `AdmmParams`.

    - ``thr_sparse_zero``: entries with ``|x| <= thr`` are zeroed in the
      final gains (`solver.cpp:144,208`).
    - ``thr_planar``: a formation whose z has sample standard deviation
      (ddof=1) below this is flat: the 1D kernel is ``[qz]`` only.
    - ``eps_eig``, ``mu``, ``thresh``, ``thresh_tr``, ``max_itr``: the ADMM
      iteration and its stop tests (`solver.cpp:264-347`).
    - ``psd_method``: the PSD step. ``'eigh'`` is the exact
      eigendecomposition with the reference's keep-all quirk,
      ``'newton'`` the Newton-Schulz matrix-sign iteration (matmuls
      only), ``'auto'`` newton at float32 and eigh at float64.
    - ``newton_iters``: the sign iteration's step budget.
    - ``newton_tol``: > 0 stops the sign iteration once its relative
      Frobenius update falls below it; 0 runs all ``newton_iters`` steps.
    - ``newton_precision``: accepted and has no effect. The reference uses
      it to pick the TPU's 3-pass bfloat16 matmul ("high") inside the
      sign iteration. The port keeps every float32 product in full
      float32 (TF32 is turned off at package import): TF32 keeps 10
      mantissa bits, fewer than the 3-pass "high", so it is not the same
      setting. Whether a TF32 sign iteration passes `validate_gains` is
      an open performance question.
    - ``newton_scale``: the sign iterate's initial scale, ``'spectral'``
      (a 12-step power iteration, floored by
      ``1.02 * min(||W||_F, ||W||_inf) / sqrt(3)``) or ``'fro'``
      (``||W||_F``).
    """

    thr_sparse_zero: float = 1e-8
    thr_planar: float = 1e-2
    eps_eig: float = 1e-5
    mu: float = 1.0
    thresh: float = 1e-4
    thresh_tr: float = 0.10
    max_itr: int = 10
    psd_method: str = "auto"
    newton_iters: int = 40
    newton_tol: float = 1e-4
    newton_precision: str = "high"
    newton_scale: str = "spectral"
