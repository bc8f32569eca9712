"""Scenario-structured (two-stage) one-phase IPM with an arrow KKT.

Port of onephase_tpu/parallel/scenario.py.  Problems

    min  f0(z) + sum_k fk(x_k, z; d_k)
    s.t. lcon <= ck(x_k, z; d_k) <= ucon   for each scenario k
         bounds on z and x_k

run the full one-phase algorithm, with the KKT linear algebra kept in
arrow form (ops/block_schur.py): per-scenario Cholesky factors and a
coupling border assembled by summation; the dense (nz + K nx)^2 Schur
complement is never formed.  Scenario work (Jacobian and Hessian blocks by
`torch.func`, Q assembly by einsum) is batched over the scenarios.

Batch-first like the rest of the port: blocks are (B, K, nx, nx) and a
single solve is B = 1.  Lanes (`kkt.linear_solver_type`):

- `pallas`: the scenario blocks and the border are factored by the hand
  kernel K2 (ops/cholesky.pallas_chol) on the card, one launch for each
  per delta attempt; by its plain version on the CPU;
- `xla` (and `eigh`, which the JAX package runs as `xla` on this path):
  `torch.linalg.cholesky_ex`.

The JAX package factors the blocks with `jnp.linalg.cholesky` on every
lane, and its `pallas` and `invchol` lanes stop in `finalize_solver`,
which this kernel does not override there; the port's `pallas` lane is
therefore held to the JAX `xla` lane, and `invchol` raises here.

`TwoStageSpec.to_nlpspec()` lowers to a flat NLPSpec, so the dense solver
cross-checks the structured path.  The JAX package's mesh sharding of the
scenario axis is not ported: a `mesh` raises.
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
from ..ops.block_schur import ArrowFactor, arrow_factor, arrow_solve


@dataclass
class TwoStageSpec:
    f0: Callable            # z -> scalar first-stage cost
    fk: Callable            # (xk, z, data_k) -> scalar scenario cost
    ck: Callable            # (xk, z, data_k) -> (mc,) scenario constraints
    # name -> callable dtype -> tensor with leading axis K (models/qp.py
    # `Data`: one copy per dtype, all on one device)
    data: Dict[str, Any]
    K: int                  # number of scenarios
    nz: int                 # coupling variable count
    nx: int                 # per-scenario variable count
    mc: int                 # per-scenario constraint count
    lcon: np.ndarray        # (mc,) per-scenario constraint bounds
    ucon: np.ndarray
    lz: np.ndarray          # (nz,)
    uz: np.ndarray
    lx: np.ndarray          # (nx,)
    ux: np.ndarray
    z0: np.ndarray
    x0: np.ndarray          # (nx,) replicated start or (K, nx)
    name: str = "two_stage"

    def scenario_data(self, dtype) -> Dict[str, torch.Tensor]:
        """The per-scenario data in `dtype` (the dtype of the x it meets)."""
        return {k: v(dtype) for k, v in self.data.items()}

    @property
    def device(self):
        for v in self.data.values():
            return v(torch.float64).device
        return None

    def to_nlpspec(self) -> NLPSpec:
        K, nz, nx, mc = self.K, self.nz, self.nx, self.mc
        fk, ck, f0 = self.fk, self.ck, self.f0

        def split(xflat):
            return xflat[:nz], xflat[nz:].reshape(K, nx)

        def f(xflat):
            z, X = split(xflat)
            vals = vmap(fk, in_dims=(0, None, 0))(
                X, z, self.scenario_data(xflat.dtype))
            return f0(z) + vals.sum()

        def c(xflat):
            z, X = split(xflat)
            C = vmap(ck, in_dims=(0, None, 0))(
                X, z, self.scenario_data(xflat.dtype))
            return C.reshape(K * mc)

        x0 = np.broadcast_to(self.x0, (K, nx)).reshape(-1)
        return NLPSpec(
            f=f, c=c,
            lcon=np.tile(self.lcon, K), ucon=np.tile(self.ucon, K),
            lvar=np.concatenate([self.lz, np.tile(self.lx, K)]),
            uvar=np.concatenate([self.uz, np.tile(self.ux, K)]),
            x0=np.concatenate([self.z0, x0]),
            name=self.name)


class ScenarioKernel(OnePhaseKernel):
    """OnePhaseKernel whose KKT path is the arrow factorization.

    The variable layout is the flat [z; vec(X)] of `to_nlpspec`, so the
    state and line-search machinery is inherited unchanged; only the block
    linear algebra is overridden."""

    def __init__(self, spec: TwoStageSpec, pars: Params, dtype=None,
                 device=None, mesh=None):
        """`device` defaults to the CUDA card and must be where the spec's
        data lives; `dtype` defaults to float64."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding of the scenario axis is not ported to "
                "onephase_tpu_torch")
        if pars.kkt.kkt_solver_type != "schur":
            raise ValueError("ScenarioKernel implements the schur path only")
        if pars.kkt.linear_solver_type not in ("xla", "pallas", "eigh"):
            raise ValueError("ScenarioKernel factors its own blocks; set "
                             "kkt.linear_solver_type='xla' (cholesky_ex) or "
                             "'pallas' (the K2 kernel)")
        self.use_pallas = pars.kkt.linear_solver_type == "pallas"
        device = resolve_device(device)
        if spec.device is not None and spec.device.type != device.type:
            raise ValueError(f"the scenarios' data lives on {spec.device}, "
                             f"the kernel was asked for {device}")
        self.spec = spec
        nlp = canonicalize(spec.to_nlpspec(),
                           dtype=dtype or torch.float64, device=device)
        check_structured(pars, nlp.dtype)
        super().__init__(nlp, pars)

    # ---------------- structured pieces ------------------------------
    def _split_x(self, x):
        sp = self.spec
        return x[:, :sp.nz], x[:, sp.nz:].reshape(x.shape[0], sp.K, sp.nx)

    def _split_wc(self, wc):
        """(B, K mc) original-constraint weights -> (B, K, mc)."""
        return wc.reshape(wc.shape[0], self.spec.K, self.spec.mc)

    def _scenario_jacs(self, x):
        """Jx (B, K, mc, nx), Jz (B, K, mc, nz) of ck at x."""
        sp = self.spec
        z, X = self._split_x(x)

        def one(xk, zz, d):
            jx = jacrev(lambda a: sp.ck(a, zz, d))(xk)
            jz = jacrev(lambda b: sp.ck(xk, b, d))(zz)
            return jx, jz

        return vmap(vmap(one, in_dims=(0, None, 0)), in_dims=(0, 0, None))(
            X, z, sp.scenario_data(x.dtype))

    def _hess_blocks(self, x, y_eff):
        """(Hzz (B, nz, nz), Hkk (B, K, nx, nx), Hkz (B, K, nx, nz)) of the
        Lagrangian."""
        sp = self.spec
        z, X = self._split_x(x)
        wc, _ = self.nlp.split_canonical(y_eff)
        W = self._split_wc(wc)

        def lag_k(xk, zz, d, w):
            return sp.fk(xk, zz, d) - torch.dot(w, sp.ck(xk, zz, d))

        def blocks(xk, zz, d, w):
            hxx = hessian(lambda a: lag_k(a, zz, d, w))(xk)
            hxz = jacfwd(lambda b: grad(
                lambda a: lag_k(a, b, d, w))(xk))(zz)
            hzz = hessian(lambda b: lag_k(xk, b, d, w))(zz)
            return hxx, hxz, hzz

        Hkk, Hkz, Hzz_k = vmap(vmap(blocks, in_dims=(0, None, 0, 0)),
                               in_dims=(0, 0, None, 0))(
            X, z, sp.scenario_data(x.dtype), W)
        Hzz = vmap(hessian(sp.f0))(z) + Hzz_k.sum(1)
        return Hzz, Hkk, Hkz

    def _hess_mv(self, H, v):
        Hzz, Hkk, Hkz = H
        vz, vX = self._split_x(v)
        out_z = (Hzz @ vz.unsqueeze(-1)).squeeze(-1) + torch.einsum(
            "bkxz,bkx->bz", Hkz, vX)
        out_X = (torch.einsum("bkxy,bky->bkx", Hkk, vX)
                 + torch.einsum("bkxz,bz->bkx", Hkz, vz))
        return torch.cat([out_z, out_X.reshape(v.shape[0], -1)], -1)

    # ---------------- overridden KKT path ----------------------------
    def form_factor(self, p: Point, cache: Cache, prev: Factor,
                    pdata=None) -> Factor:
        nlp = self.nlp
        y_eff = p.y + _c(p.mu * self.pars.a_norm_penalty)
        Hzz, Hkk, Hkz = self._hess_blocks(p.x, y_eff)
        Jx, Jz = self._scenario_jacs(p.x)

        wc, bnd = nlp.split_canonical_sq(p.y / p.s)
        W = self._split_wc(wc)
        bnd_z, bnd_X = self._split_x(bnd)

        # the kernels take row-major blocks
        Qkk = (Hkk + torch.einsum("bkmx,bkm,bkmy->bkxy", Jx, W, Jx)
               + torch.diag_embed(bnd_X)).contiguous()
        Bk = (Hkz + torch.einsum("bkmx,bkm,bkmz->bkxz", Jx, W, Jz)
              ).contiguous()
        Qzz = (Hzz + torch.einsum("bkmz,bkm,bkmw->bkzw", Jz, W, Jz).sum(1)
               + torch.diag_embed(bnd_z)).contiguous()
        schur_diag = torch.cat([
            torch.diagonal(Qzz, dim1=-2, dim2=-1),
            torch.diagonal(Qkk, dim1=-2, dim2=-1).reshape(p.x.shape[0], -1)],
            -1)
        return Factor(Jc=(Jx, Jz), H=(Hzz, Hkk, Hkz), Q=(Qzz, Qkk, Bk),
                      schur_diag=schur_diag, L=prev.L, D=prev.D,
                      delta=prev.delta, s_f=p.s, y_f=p.y,
                      ok=torch.zeros_like(prev.ok))

    def finalize_solver(self, L):
        # the block factor IS the solve operator (Lk, LS)
        return L

    def factor(self, Q, delta, rescale=None, fact=None):
        # the arrow path never rescales: kkt_system_rescale belongs to
        # clever_symmetric, as in the JAX package
        Qzz, Qkk, Bk = Q
        f = arrow_factor(Qzz, Qkk, Bk, delta, use_pallas=self.use_pallas)
        return ((f.Lk, f.LS), Qzz.new_zeros(Qzz.shape[0], 1)), f.ok

    def _arrow_solve(self, fact, rhs):
        Lk, LS = fact.L
        rz, rX = self._split_x(rhs)
        f = ArrowFactor(Lk=Lk, LS=LS, ok=None)
        dz, dxk = arrow_solve(f, fact.Q[2], rz, rX)
        return torch.cat([dz, dxk.reshape(rhs.shape[0], -1)], -1)

    def _struct_jprod(self, fact, v):
        """Canonical J v through the scenario Jacobian blocks."""
        Jx, Jz = fact.Jc
        vz, vX = self._split_x(v)
        jc_v = (torch.einsum("bkmx,bkx->bkm", Jx, vX)
                + torch.einsum("bkmz,bz->bkm", Jz, vz))
        return self.nlp.jprod_from(jc_v.reshape(v.shape[0], -1), v)

    def _struct_jtprod(self, fact, w):
        Jx, Jz = fact.Jc
        wc, bnd = self.nlp.split_canonical(w)
        W = self._split_wc(wc)
        out_z = torch.einsum("bkmz,bkm->bkz", Jz, W).sum(1)
        out_X = torch.einsum("bkmx,bkm->bkx", Jx, W)
        return torch.cat([out_z, out_X.reshape(w.shape[0], -1)], -1) + bnd

    def compute_direction(self, fact: Factor, p: Point, cache: Cache,
                          eta_P, eta_D, eta_mu, pdata=None):
        """The Schur solve with `it_refine_num` fixed refinement passes
        through the arrow factor (the adaptive and double-single options of
        the dense path do not apply, as in the JAX package)."""
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
            dx = dx + self._arrow_solve(fact, res)
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
        """The carried Factor before the first factorization, in block
        form: nothing dense (n, n) or (m, n) is allocated."""
        sp = self.spec
        dt, dev = self.dtype, self.device
        K, nz, nx, mc = sp.K, sp.nz, sp.nx, sp.mc

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        def eye(k, *lead):
            return torch.eye(k, dtype=dt, device=dev).expand(
                *lead, k, k).contiguous()

        return Factor(
            Jc=(zeros(B, K, mc, nx), zeros(B, K, mc, nz)),
            H=(zeros(B, nz, nz), zeros(B, K, nx, nx), zeros(B, K, nx, nz)),
            Q=(zeros(B, nz, nz), zeros(B, K, nx, nx), zeros(B, K, nx, nz)),
            schur_diag=zeros(B, self.n), L=(eye(nx, B, K), eye(nz, B)),
            D=zeros(B, 1), delta=zeros(B), s_f=self._full((B, self.m), 1.0),
            y_f=self._full((B, self.m), 1.0),
            ok=torch.zeros(B, dtype=torch.bool, device=dev))
