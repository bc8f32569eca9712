"""Dual (normal-equations / Woodbury) Schur KKT path for LPs with m < n.

Port of onephase_tpu/ipm/dual.py.  The dense schur path factors the
(n, n) primal Schur complement Q = diag(bnd) + Jc^T diag(wc) Jc (H = 0).
With m_orig well below n, and every variable bounded so diag(bnd) > 0,
this path factors the m_orig x m_orig dual normal matrix instead, by the
Woodbury identity:

    (D + Jc^T W Jc)^-1 = D^-1 - D^-1 Jc^T S^-1 Jc D^-1,
    S = W^-1 + Jc D^-1 Jc^T                      (m_orig, m_orig)

with D = diag(bnd) + delta.  A factorization costs O(m^2 n + m^3/3)
instead of O(n^2 m + n^3/3), and every backsolve is three batched matvecs
(Jc, S^-1, Jc^T) plus diagonal scalings.

The factor is only a preconditioner: the refinement of the base kernel
measures its residual against the true J products.  With D > 0 and W > 0,
Q + delta I is SPD iff S is, so the Cholesky of S with the dense path's
pivot screen (`_chol_ok`) is the inertia test.  As in the JAX package, S
is factored on the `xla` route (`torch.linalg.cholesky_ex`) and inverted
by `xla_chol_inv_from_L`: none of it is a TPU kernel there.

Gating (the JAX package's ValueErrors): kkt_solver_type='schur_dual', a
declared-zero Hessian (NLPSpec.zero_hess), m_orig >= 1, and
factor_precision 'same' or 'f32'.  `make_kernel` builds this kernel for
kkt_solver_type='schur_dual' and the dense kernel otherwise.
"""

from __future__ import annotations

import torch

from ..config import Params
from ..nlp import CanonNLP, _mtv, _mv
from ..ops.cholesky import xla_chol_inv_from_L
from .core import OnePhaseKernel
from .state import Factor


class SchurDualKernel(OnePhaseKernel):
    """OnePhaseKernel whose factorization object is the dual normal matrix.

    The Factor slots hold tuples (batch-first):
      Q -> (wc, bnd, Jc) at the factor point while forming; None when
           carried (rebuilt by `_fact_q`)
      L -> (Ls, d_inv, A) from `factor`, (S^-1, d_inv, A) after
           `finalize_solver`: S's Cholesky factor or its explicit inverse
           (B, m_orig, m_orig), 1 / (bnd + delta) (B, n) and the Jacobian
           in the factor dtype (B, m_orig, n), None when it is a folded
           constant (read from the fold in `chol_solve`)
      D -> ones (B, 1), unused
    """

    def __init__(self, nlp: CanonNLP, pars: Params):
        if pars.kkt.kkt_solver_type != "schur_dual":
            raise ValueError("SchurDualKernel requires kkt_solver_type="
                             "'schur_dual'")
        if pars.kkt.factor_precision == "f32_fallback":
            raise ValueError("schur_dual supports factor_precision 'same' "
                             "or 'f32' (no per-factorization fallback)")
        # the base kernel's schur branches (zero-H fast path, delta and
        # refinement machinery) run as they are; the operator is replaced
        # by the overrides below
        pars = pars.with_overrides({"kkt.kkt_solver_type": "schur",
                                    "kkt.linear_solver_type": "xla"})
        super().__init__(nlp, pars)
        if not self._H_zero:
            raise ValueError("schur_dual requires NLPSpec.zero_hess (LP)")
        if nlp.m_orig < 1:
            raise ValueError("schur_dual needs original constraint rows")
        self._mo = nlp.m_orig

    # ---------------- factorization pieces ---------------------------
    def form_factor(self, p, cache, prev: Factor, pdata=None) -> Factor:
        nlp = self.nlp
        _, Jc = self._factor_point_jh(p, prev, None, pdata)
        d = p.y / p.s
        wc, bnd = nlp.split_canonical_sq(d)
        schur_diag = nlp.jtdj_diag(Jc, d)
        return Factor(Jc=self._store_jc(Jc), H=None,
                      Q=(wc, bnd, self._store_jc(Jc)),
                      schur_diag=schur_diag.to(self.dtype),
                      L=prev.L, D=prev.D, delta=prev.delta,
                      s_f=p.s, y_f=p.y, ok=torch.zeros_like(prev.ok))

    def _store_q(self, Q):
        return None

    def _fact_q(self, fact: Factor):
        wc, bnd = self.nlp.split_canonical_sq(fact.y_f / fact.s_f)
        return (wc, bnd, self._fact_jc(fact))

    def factor(self, Q, delta, rescale=None, fact=None):
        wc, bnd, jc = Q
        jc = self._Jc_const if self._Jc_const is not None else jc
        fdt = self.factor_store_dtype
        dtil = bnd + delta.to(bnd.dtype)[:, None]
        ok_d = (dtil > 0.0).all(-1)
        d_inv = torch.where(dtil > 0.0, 1.0 / dtil,
                            torch.zeros_like(dtil)).to(fdt)
        # W^-1 with an underflow floor: wc (folded y/s sums) is strictly
        # positive, but a float32 underflow would poison S with inf
        w = torch.clamp(wc, min=torch.finfo(wc.dtype).tiny * 1e4).to(fdt)
        A = jc.to(fdt)
        S = (A * d_inv[:, None, :]) @ A.transpose(-1, -2)
        S.diagonal(dim1=-2, dim2=-1).add_(1.0 / w)
        Ls, ok_s = self._chol_ok(S)
        A_store = None if self._Jc_const is not None else A
        D = torch.ones(dtil.shape[0], 1, dtype=fdt, device=dtil.device)
        return ((Ls, d_inv, A_store), D), ok_d & ok_s

    def finalize_solver(self, L):
        Ls, d_inv, A = L
        return (xla_chol_inv_from_L(Ls), d_inv, A)

    def chol_solve(self, L, b):
        S_inv, d_inv, A = L
        if self._Jc_const is not None:
            A = self._Jc_const.to(d_inv.dtype)
        out_dt = b.dtype
        z = b.to(d_inv.dtype) * d_inv
        u = _mv(S_inv, _mv(A, z))
        return (z - d_inv * _mtv(A, u)).to(out_dt)

    def _empty_factor(self, B) -> Factor:
        n, m, mo = self.n, self.m, self._mo
        dt, fdt = self.dtype, self.factor_store_dtype
        dev = self.device
        A = (None if self._Jc_const is not None
             else torch.zeros(B, mo, n, dtype=fdt, device=dev))
        Jc = torch.zeros(B, mo, n, dtype=dt, device=dev)
        return Factor(Jc=self._store_jc(Jc), H=None, Q=None,
                      schur_diag=self._full((B, n), 0.0),
                      L=(torch.eye(mo, dtype=fdt, device=dev).expand(
                          B, mo, mo), self._full((B, n), 1.0, fdt), A),
                      D=self._full((B, 1), 1.0, fdt),
                      delta=self._full((B,), 0.0),
                      s_f=self._full((B, m), 1.0), y_f=self._full((B, m), 1.0),
                      ok=torch.zeros(B, dtype=torch.bool, device=dev))


def make_kernel(nlp: CanonNLP, pars: Params) -> OnePhaseKernel:
    """Kernel factory: kkt_solver_type='schur_dual' is a subclass, not a
    branch of the dense kernel (onephase_tpu/ipm/dual.py:159-164)."""
    if pars.kkt.kkt_solver_type == "schur_dual":
        return SchurDualKernel(nlp, pars)
    return OnePhaseKernel(nlp, pars)
