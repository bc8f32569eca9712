"""Chain-structured (multiple-shooting / OCP) one-phase IPM.

Port of onephase_tpu/parallel/chain.py.  Stage-chained NLPs

    min  sum_k fk(x_k, x_{k+1}; d_k)               k = 0..K-2
    s.t. lcon <= ck(x_k, x_{k+1}; d_k) <= ucon     per stage pair
         lx <= x_k <= ux

(discretized optimal control, chained Rosenbrock / CHAIN-style problems)
run the full one-phase algorithm with the Schur complement kept in
block-tridiagonal form (ops/block_tridiag.py): O(K nb^3) factorization
instead of O((K nb)^3) dense, and no (n, n) object anywhere.  Stage work
(Jacobian and Hessian blocks by `torch.func`, Q assembly by einsum) is
batched over the stages; only the K-step block recursion is sequential.

Batch-first like the rest of the port: blocks are (B, K, nb, nb) and a
single solve is B = 1.  Lanes (`kkt.linear_solver_type`):

- `pallas`: the factor is (Ci, Ek), block inverses and subdiagonal blocks;
  on the card one launch of the hand kernel K7 per δ attempt and one of K5
  per backsolve (ops/tridiag_pallas.py), on the CPU their plain versions
  (`tridiag_factor` + `block_inverses`, the JAX package's hybrid);
- `xla`: the factor is (Ck, Ek) from `tridiag_factor`, solved by
  `tridiag_solve`; with `kkt.chain_partitions` > 1 the nested-dissection
  `partitioned_factor` / `partitioned_solve`.

`ChainSpec.to_nlpspec()` lowers to a flat NLPSpec, so the dense solver
cross-checks the structured path.  The JAX package's mesh sharding of the
partitions is not ported: a `mesh` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from ..config import Params
from ..ipm.core import OnePhaseKernel, _c, _norm_inf, check_structured
from ..ipm.state import Cache, Dir, Factor, Point
from ..nlp import NLPSpec, canonicalize, resolve_device
from ..ops.block_tridiag import (TridiagFactor, partitioned_factor,
                                 partitioned_solve, tridiag_factor,
                                 tridiag_matvec, tridiag_solve)
from ..ops.tridiag_pallas import pallas_tridiag_factor, pallas_tridiag_solve


@dataclass
class ChainSpec:
    fk: Callable            # (xk, xk1, data_k) -> scalar stage cost
    ck: Callable            # (xk, xk1, data_k) -> (mc,) stage constraints
    # name -> callable dtype -> tensor with leading axis K-1 (models/qp.py
    # `Data`: one copy per dtype, all on one device)
    data: Dict[str, Any]
    K: int                  # number of stages (variables x_0..x_{K-1})
    nx: int                 # per-stage variable count
    mc: int                 # per-stage-pair constraint count
    lcon: np.ndarray        # (mc,)
    ucon: np.ndarray
    lx: np.ndarray          # (nx,) per-stage bounds
    ux: np.ndarray
    x0: np.ndarray          # (nx,) replicated start or (K, nx)
    name: str = "chain"

    def stage_data(self, dtype) -> Dict[str, torch.Tensor]:
        """The per-stage data in `dtype` (the dtype of the x it meets)."""
        return {k: v(dtype) for k, v in self.data.items()}

    @property
    def device(self):
        for v in self.data.values():
            return v(torch.float64).device
        return None

    def to_nlpspec(self) -> NLPSpec:
        K, nx, mc = self.K, self.nx, self.mc
        fk, ck = self.fk, self.ck

        def f(xflat):
            X = xflat.reshape(K, nx)
            vals = vmap(fk)(X[:-1], X[1:], self.stage_data(xflat.dtype))
            return vals.sum()

        def c(xflat):
            X = xflat.reshape(K, nx)
            C = vmap(ck)(X[:-1], X[1:], self.stage_data(xflat.dtype))
            return C.reshape((K - 1) * mc)

        x0 = np.broadcast_to(self.x0, (K, nx)).reshape(-1)
        return NLPSpec(
            f=f, c=c,
            lcon=np.tile(self.lcon, K - 1), ucon=np.tile(self.ucon, K - 1),
            lvar=np.tile(self.lx, K), uvar=np.tile(self.ux, K),
            x0=x0, name=self.name)


class ChainKernel(OnePhaseKernel):
    """OnePhaseKernel whose KKT linear algebra is block-tridiagonal."""

    def __init__(self, spec: ChainSpec, pars: Params, dtype=None,
                 device=None, mesh=None):
        """`device` defaults to the CUDA card and must be where the spec's
        data lives; `dtype` defaults to float64."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding of the chain partitions is not ported to "
                "onephase_tpu_torch")
        if pars.kkt.kkt_solver_type != "schur":
            raise ValueError("ChainKernel implements the schur path only")
        if pars.kkt.linear_solver_type not in ("xla", "pallas"):
            raise ValueError("ChainKernel has its own block solve path; "
                             "set kkt.linear_solver_type='xla' (sequential "
                             "block recursion) or 'pallas' (the K5/K7 "
                             "kernels)")
        self.use_pallas = pars.kkt.linear_solver_type == "pallas"
        self.partitions = int(pars.kkt.chain_partitions)
        if self.use_pallas and self.partitions > 1:
            raise ValueError("pallas tridiag backend is sequential; "
                             "incompatible with chain_partitions > 1")
        if self.partitions > 1 and (spec.K % self.partitions
                                    or spec.K // self.partitions < 2):
            raise ValueError(
                f"chain_partitions={self.partitions} needs K={spec.K} "
                "= P*Kc with Kc>=2")
        check_structured(pars, dtype or torch.float64)
        device = resolve_device(device)
        if spec.device is not None and spec.device.type != device.type:
            raise ValueError(f"the chain's data lives on {spec.device}, the "
                             f"kernel was asked for {device}")
        self.spec = spec
        nlp = canonicalize(spec.to_nlpspec(),
                           dtype=dtype or torch.float64, device=device)
        super().__init__(nlp, pars)

    # ---------------- structured pieces ------------------------------
    def _split_x(self, x):
        sp = self.spec
        return x.reshape(x.shape[0], sp.K, sp.nx)

    def _split_wc(self, wc):
        sp = self.spec
        return wc.reshape(wc.shape[0], sp.K - 1, sp.mc)

    def _stage_jacs(self, x):
        """Ja, Jb (B, K-1, mc, nx): d ck / d x_k and / d x_{k+1}."""
        sp = self.spec
        X = self._split_x(x)

        def one(xa, xb, d):
            ja = jacrev(lambda a: sp.ck(a, xb, d))(xa)
            jb = jacrev(lambda b: sp.ck(xa, b, d))(xb)
            return ja, jb

        return vmap(vmap(one), in_dims=(0, 0, None))(
            X[:, :-1], X[:, 1:], sp.stage_data(x.dtype))

    def _hess_blocks(self, x, y_eff):
        """Lagrangian Hessian as (Hd (B, K, nx, nx), Hs (B, K-1, nx, nx))
        where Hs[k] = d2L / d x_{k+1} d x_k (the subdiagonal block)."""
        sp = self.spec
        X = self._split_x(x)
        wc, _ = self.nlp.split_canonical(y_eff)
        W = self._split_wc(wc)

        def lag_k(xa, xb, d, w):
            return sp.fk(xa, xb, d) - torch.dot(w, sp.ck(xa, xb, d))

        def blocks(xa, xb, d, w):
            haa = hessian(lambda a: lag_k(a, xb, d, w))(xa)
            hbb = hessian(lambda b: lag_k(xa, b, d, w))(xb)
            # hba[i, j] = d2 L / d xb_i d xa_j
            hba = jacfwd(lambda a: grad(
                lambda b: lag_k(a, b, d, w))(xb))(xa)
            return haa, hbb, hba

        Haa, Hbb, Hba = vmap(vmap(blocks), in_dims=(0, 0, None, 0))(
            X[:, :-1], X[:, 1:], sp.stage_data(x.dtype), W)
        Hd = x.new_zeros(X.shape + (sp.nx,))
        Hd[:, :-1] += Haa
        Hd[:, 1:] += Hbb
        return Hd, Hba

    def _hess_mv(self, H, v):
        Hd, Hs = H
        return tridiag_matvec(Hd, Hs, self._split_x(v)).reshape(v.shape)

    # ---------------- overridden KKT path ----------------------------
    def form_factor(self, p: Point, cache: Cache, prev: Factor,
                    pdata=None) -> Factor:
        nlp = self.nlp
        y_eff = p.y + _c(p.mu * self.pars.a_norm_penalty)
        Hd, Hs = self._hess_blocks(p.x, y_eff)
        Ja, Jb = self._stage_jacs(p.x)

        wc, bnd = nlp.split_canonical_sq(p.y / p.s)
        W = self._split_wc(wc)

        # Q diagonal blocks: H + Ja'W Ja (stage k) + Jb'W Jb (stage k-1)
        Qd = Hd + torch.diag_embed(self._split_x(bnd))
        Qd[:, :-1] += torch.einsum("bkma,bkm,bkmc->bkac", Ja, W, Ja)
        Qd[:, 1:] += torch.einsum("bkma,bkm,bkmc->bkac", Jb, W, Jb)
        # subdiagonal block Q[k+1, k]: Jb[k]' W_k Ja[k] + Hba[k]
        # (contiguous: the kernels take row-major blocks, and the Hessian
        # blocks come out of vmap(jacfwd) in another layout)
        Qs = (Hs + torch.einsum("bkmi,bkm,bkmj->bkij", Jb, W, Ja)
              ).contiguous()

        schur_diag = torch.diagonal(Qd, dim1=-2, dim2=-1).reshape(
            p.x.shape[0], -1)
        return Factor(Jc=(Ja, Jb), H=(Hd, Hs), Q=(Qd, Qs),
                      schur_diag=schur_diag, L=prev.L, D=prev.D,
                      delta=prev.delta, s_f=p.s, y_f=p.y,
                      ok=torch.zeros_like(prev.ok))

    def finalize_solver(self, L):
        # the structured factor IS the solve operator (block tuple)
        return L

    def factor(self, Q, delta, rescale=None, fact=None):
        Qd, Qs = Q
        D = Qd.new_zeros(Qd.shape[0], 1)
        if self.partitions > 1:
            pf = partitioned_factor(Qd, Qs, delta, self.partitions)
            return (pf, D), pf.ok
        if self.use_pallas:
            _, Ci, Ek, ok = pallas_tridiag_factor(Qd, Qs, delta)    # K7
            return ((Ci, Ek), D), ok
        f = tridiag_factor(Qd, Qs, delta)
        return ((f.Ck, f.Ek), D), f.ok

    def _tri_solve(self, fact, rhs):
        R = self._split_x(rhs)
        if self.partitions > 1:
            return partitioned_solve(fact.L, R).reshape(rhs.shape)
        if self.use_pallas:
            Ci, Ek = fact.L
            return pallas_tridiag_solve(Ci, Ek, R).reshape(rhs.shape)  # K5
        Ck, Ek = fact.L
        return tridiag_solve(TridiagFactor(Ck=Ck, Ek=Ek, ok=None),
                             R).reshape(rhs.shape)

    def _struct_jprod(self, fact, v):
        Ja, Jb = fact.Jc
        V = self._split_x(v)
        jc_v = (torch.einsum("bkma,bka->bkm", Ja, V[:, :-1])
                + torch.einsum("bkma,bka->bkm", Jb, V[:, 1:]))
        return self.nlp.jprod_from(jc_v.reshape(v.shape[0], -1), v)

    def _struct_jtprod(self, fact, w):
        Ja, Jb = fact.Jc
        wc, bnd = self.nlp.split_canonical(w)
        W = self._split_wc(wc)
        out = w.new_zeros(w.shape[0], self.spec.K, self.spec.nx)
        out[:, :-1] += torch.einsum("bkma,bkm->bka", Ja, W)
        out[:, 1:] += torch.einsum("bkma,bkm->bka", Jb, W)
        return out.reshape(w.shape[0], -1) + bnd

    def compute_direction(self, fact: Factor, p: Point, cache: Cache,
                          eta_P, eta_D, eta_mu, pdata=None):
        """The Schur solve with `it_refine_num` fixed refinement passes
        through the block factor (the adaptive and double-single options
        of the dense path do not apply, as in the JAX package)."""
        dual_r, primal_r, comp_r = self.build_rhs(p, cache, eta_P, eta_D,
                                                  eta_mu, pdata)
        y_f, s_f = fact.y_f, fact.s_f
        S_vec = y_f / s_f
        delta = _c(fact.delta)
        sym_primal = primal_r + comp_r / y_f
        schur_rhs = dual_r + self._struct_jtprod(
            fact, primal_r * S_vec + comp_r / s_f)

        dx = torch.zeros_like(schur_rhs)
        res = schur_rhs
        for _ in range(self.pars.kkt.it_refine_num):
            dx = dx + self._tri_solve(fact, res)
            jac_res = self._struct_jtprod(
                fact, S_vec * self._struct_jprod(fact, dx))
            res = schur_rhs - (jac_res + self._hess_mv(fact.H, dx)
                               + delta * dx)

        jdx = self._struct_jprod(fact, dx)
        dy = -(jdx - sym_primal) * S_vec
        ds = jdx - primal_r
        dmu = -(1.0 - eta_mu) * p.mu
        dbeta = -(1.0 - eta_P) * p.beta
        direction = Dir(x=dx, y=dy, s=ds, mu=dmu, beta=dbeta)

        pred_lag = (delta * dx + self._hess_mv(fact.H, dx)
                    - self._struct_jtprod(fact, dy))
        err = torch.cat([pred_lag - dual_r, jdx - ds - primal_r,
                         s_f * dy + y_f * ds - comp_r], -1)
        rhs_norm = _norm_inf(torch.cat([dual_r, primal_r, comp_r], -1))
        return direction, _norm_inf(err) / rhs_norm

    def _empty_factor(self, B) -> Factor:
        """The carried Factor before the first factorization, in block form:
        nothing dense (n, n) or (m, n) is allocated."""
        sp = self.spec
        dt, dev = self.dtype, self.device
        nx, K, mc = sp.nx, sp.K, sp.mc

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        eye = torch.eye(nx, dtype=dt, device=dev).expand(B, K, nx, nx)
        if self.partitions > 1:
            # identity-block factorization fixes the factor's structure;
            # ok=False marks it stale
            L0 = partitioned_factor(eye.contiguous(), zeros(B, K - 1, nx, nx),
                                    0.0, self.partitions)
        else:
            L0 = (eye.contiguous(), zeros(B, K - 1, nx, nx))
        return Factor(
            Jc=(zeros(B, K - 1, mc, nx), zeros(B, K - 1, mc, nx)),
            H=(zeros(B, K, nx, nx), zeros(B, K - 1, nx, nx)),
            Q=(zeros(B, K, nx, nx), zeros(B, K - 1, nx, nx)),
            schur_diag=zeros(B, self.n), L=L0, D=zeros(B, 1),
            delta=zeros(B), s_f=self._full((B, self.m), 1.0),
            y_f=self._full((B, self.m), 1.0),
            ok=torch.zeros(B, dtype=torch.bool, device=dev))
