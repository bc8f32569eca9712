"""Problem abstraction + canonicalizer, on `torch.func`.

Port of onephase_tpu/nlp.py.  A raw problem is::

    min f(x)  s.t.  lcon <= c(x) <= ucon,  lvar <= x <= uvar

and its canonical form (one slack per finite bound side, rows in the
reference's order) is ``a(x) >= 0`` with

    a(x) = [ c(x)[li] - l ;  u - c(x)[ui] ;  x[lvi] - lv ;  uv - x[uvi] ]

Fixed variables (lvar == uvar) are eliminated and re-inserted for oracle
evaluation.  The canonical Jacobian ``J = [Jc[li]; -Jc[ui]; I[lvi];
-I[uvi]]`` is never materialized: every canonical product goes through the
original Jacobian `Jc` plus index gathers/scatters.

Every oracle is **batch-first**: x is (B, n) and the results carry the same
leading axis.  The user's `f` and `c` are written for one instance (a 1-D
x); derivatives come from `torch.func` (grad, jacrev/jacfwd, hessian, jvp,
vjp) and the batch axis from `torch.func.vmap`.  `f` and `c` must compute
in the dtype of the x they are given: the solve dtype for the in-loop
oracles and float64 for the `_hi` oracles.

Parametric problems (`NLPSpec.pdata`): `f(x, pdata)`, `c(x, pdata)` and
the optional user Jacobian `jac(x, pdata) -> (m_orig, n)` take the
instance's data, a dict of tensors.  Every oracle takes a `pdata`
argument: the batch's own data (each leaf with the leading batch axis,
vmapped beside x) or None for the template `_pdata0` (the spec's data in
the NLP's dtype and on its device), shared by the batch.  The `_hi`
oracles see the data in float64.  With `jac` given, `jac_orig` returns the
oracle's matrix and no derivative of c is taken for it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, jvp, vjp, vmap

__all__ = ["NLPSpec", "CanonNLP", "canonicalize", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card.  Without a card the CPU must be asked for by name: there is
    no quiet fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: onephase_tpu_torch runs on the card unless "
            "asked otherwise; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclass
class NLPSpec:
    """Raw user problem (same fields as onephase_tpu.nlp.NLPSpec)."""

    f: Callable          # x -> scalar objective (one instance, 1-D x)
    x0: np.ndarray       # starting point, full-variable space
    c: Optional[Callable] = None    # x -> (m_orig,) constraint body, or None
    lcon: Optional[np.ndarray] = None
    ucon: Optional[np.ndarray] = None
    lvar: Optional[np.ndarray] = None
    uvar: Optional[np.ndarray] = None
    lin: Sequence[int] = field(default_factory=tuple)   # linear constraints
    name: str = "nlp"
    # structure declarations: constant Jacobian / constant Lagrangian
    # Hessian (evaluated once) and identically-zero Hessian (never formed)
    constant_jac: bool = False
    constant_hess: bool = False
    zero_hess: bool = False
    # parametric problem data: f(x, pdata) / c(x, pdata) with pdata a dict
    # of arrays (a batch of same-structure instances differing only in
    # data shares one kernel); `jac` ((x, pdata) -> (m_orig, n), or x ->
    # (m_orig, n) without pdata) bypasses autodiff for the Jacobian
    pdata: Optional[dict] = None
    jac: Optional[Callable] = None

    def __post_init__(self):
        self.x0 = np.asarray(self.x0, dtype=np.float64)
        nv = self.x0.shape[0]
        if self.lvar is None:
            self.lvar = np.full(nv, -np.inf)
        if self.uvar is None:
            self.uvar = np.full(nv, np.inf)
        self.lvar = np.asarray(self.lvar, dtype=np.float64)
        self.uvar = np.asarray(self.uvar, dtype=np.float64)
        if self.c is None:
            self.lcon = np.zeros(0)
            self.ucon = np.zeros(0)
        else:
            if self.lcon is None or self.ucon is None:
                raise ValueError(f"{self.name}: c given without lcon/ucon")
            self.lcon = np.asarray(self.lcon, dtype=np.float64)
            self.ucon = np.asarray(self.ucon, dtype=np.float64)


def _mv(A, v):
    """A @ v for a shared (r, k) or batched (B, r, k) A and v (B, k)."""
    if A.dim() == 2:
        return v @ A.T
    return torch.bmm(A, v.unsqueeze(-1)).squeeze(-1)


def _mtv(A, w):
    """A^T @ w for a shared (r, k) or batched (B, r, k) A and w (B, r)."""
    if A.dim() == 2:
        return w @ A
    return torch.bmm(A.transpose(-1, -2), w.unsqueeze(-1)).squeeze(-1)


class CanonNLP:
    """Canonicalized problem with batch-first torch oracles.

    Index arrays are kept both as host numpy (shapes, host-side result
    assembly) and as device tensors (gathers/scatters in the oracles).
    """

    def __init__(self, spec: NLPSpec, dtype=torch.float64, device=None):
        self.spec = spec
        self.name = spec.name
        self.dtype = dtype
        self.device = resolve_device(device)

        lvar, uvar = spec.lvar, spec.uvar
        nv_full = lvar.shape[0]

        # --- fixed-variable elimination (reference _i_not_fixed) ---
        free = np.nonzero(lvar != uvar)[0]
        self.free_idx = free
        self.n_full = nv_full
        self.n = free.shape[0]
        self._x_template = np.array(lvar, dtype=np.float64)
        self._x_template[~np.isfinite(self._x_template)] = 0.0

        self.lvar = lvar[free]
        self.uvar = uvar[free]
        self.x0 = spec.x0[free]

        # --- finite-bound row maps (reference Class_bounds) ---
        lcon, ucon = spec.lcon, spec.ucon
        self.m_orig = lcon.shape[0]
        self.li = np.nonzero(lcon > -np.inf)[0]
        self.ui = np.nonzero(ucon < np.inf)[0]
        self.lvi = np.nonzero(self.lvar > -np.inf)[0]
        self.uvi = np.nonzero(self.uvar < np.inf)[0]
        self.l = lcon[self.li]
        self.u = ucon[self.ui]
        self.lv = self.lvar[self.lvi]
        self.uv = self.uvar[self.uvi]

        self.n_lcon = self.li.shape[0]
        self.n_ucon = self.ui.shape[0]
        self.n_lvar = self.lvi.shape[0]
        self.n_uvar = self.uvi.shape[0]
        self.m_cons = self.n_lcon + self.n_ucon
        self.m_bounds = self.n_lvar + self.n_uvar
        self.m = self.m_cons + self.m_bounds

        is_lin = np.zeros(self.m_orig, dtype=bool)
        is_lin[np.asarray(list(spec.lin), dtype=int)] = True
        self.lin_mask = np.concatenate([
            is_lin[self.li], is_lin[self.ui],
            np.ones(self.m_bounds, dtype=bool),
        ])
        is_eq = lcon == ucon
        self.eqbound_mask = np.concatenate([
            is_eq[self.li], is_eq[self.ui],
            np.ones(self.m_bounds, dtype=bool),
        ])

        gap = self.uvar - self.lvar
        if np.any(gap < 1e-8):
            raise ValueError(f"{spec.name}: variable bounds too close (gap < 1e-8)")
        if self.m == 0:
            raise ValueError(
                "Unconstrained minimization problems are unsupported "
                "(reference: one_phase.jl:25-27)")

        dev = self.device

        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=dev)

        def val(a, dt=dtype):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   dtype=dt, device=dev)

        self._j = {
            "li": idx(self.li), "ui": idx(self.ui),
            "lvi": idx(self.lvi), "uvi": idx(self.uvi),
            "l": val(self.l), "u": val(self.u),
            "lv": val(self.lv), "uv": val(self.uv),
        }
        w1 = np.zeros(self.m_orig)
        np.add.at(w1, self.li, 1.0)
        np.add.at(w1, self.ui, -1.0)
        b1 = np.zeros(self.n)
        np.add.at(b1, self.lvi, 1.0)
        np.add.at(b1, self.uvi, -1.0)
        self._wc_ones = val(w1)
        self._bnd_ones = val(b1)
        self._wc_ones_hi = val(w1, torch.float64)
        self._bnd_ones_hi = val(b1, torch.float64)
        self._free_t = idx(free)
        self._tmpl = {dt: val(self._x_template, dt)
                      for dt in {dtype, torch.float64}}

        self._f_raw = spec.f
        self._c_raw = spec.c
        self._jac_raw = spec.jac

        # parametric problem data: the template on the device; a batch's
        # own data flows in through the oracles' `pdata` argument (from
        # State.pdata)
        self.parametric = spec.pdata is not None
        self._pdata0 = (self.pdata_to(spec.pdata) if self.parametric
                        else None)

    def pdata_to(self, pdata, dtype=None):
        """`pdata` (a dict of arrays or tensors) as tensors on the NLP's
        device, the floating leaves in `dtype` (default: the NLP's)."""
        dt = dtype or self.dtype
        out = {}
        for k, v in pdata.items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.to(dt) if t.is_floating_point() else t
        return out

    def _pd(self, pdata, hi=False):
        """(data, batched): the batch's own pdata (its leaves vmapped with
        x), or the template shared by the batch; None when the problem is
        not parametric.  `hi`: the floating leaves in float64."""
        if not self.parametric:
            return None, False
        batched = bool(pdata)
        pd = pdata if batched else self._pdata0
        if hi:
            pd = self.pdata_to(pd, torch.float64)
        return pd, batched

    def _bmap(self, fn, pdata, *args, hi=False):
        """vmap `fn(*args_b, pd_b)` over the batch axis of `args` (and of
        pdata when it is the batch's own)."""
        pd, batched = self._pd(pdata, hi)
        if batched:
            return vmap(fn)(*args, pd)
        return vmap(lambda *a: fn(*a, pd))(*args)

    # ------------------------------------------------------------------
    # single-instance raw oracles (1-D x, any float dtype)
    def _full_x1(self, x):
        if self.n == self.n_full:
            return x
        return self._tmpl[x.dtype].index_copy(0, self._free_t, x)

    def _call(self, fn, x, pd):
        xf = self._full_x1(x)
        return fn(xf, pd) if self.parametric else fn(xf)

    def _f1(self, x, pd=None):
        v = self._call(self._f_raw, x, pd)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return v.to(x.dtype).reshape(())

    def _c1(self, x, pd=None):
        v = self._call(self._c_raw, x, pd)
        return v.to(x.dtype).reshape(self.m_orig)

    def _jac1(self, x, pd=None):
        """The user Jacobian oracle's (m_orig, n) matrix in reduced space."""
        J = self._call(self._jac_raw, x, pd)
        if not isinstance(J, torch.Tensor):
            J = torch.as_tensor(np.asarray(J), device=x.device)
        J = J.to(x.dtype).reshape(self.m_orig, self.n_full)
        if self.n != self.n_full:
            J = J.index_select(1, self._free_t)
        return J

    def _c_jtw1(self, x, W, pd=None):
        """c(x) and J(x)^T w for each row w of W (k, m_orig): one forward
        pass, k reverse passes."""
        cval, pull = vjp(lambda xx: self._c1(xx, pd), x)
        return cval, torch.stack([pull(W[i])[0] for i in range(W.shape[0])])

    def _zeros(self, x, k):
        return torch.zeros(x.shape[0], k, dtype=x.dtype, device=x.device)

    # ------------------------------------------------------------------
    # batched raw oracles in reduced space
    def f(self, x, pdata=None):
        """Objective (B,) (reference eval_f)."""
        return self._bmap(self._f1, pdata, x)

    def c(self, x, pdata=None):
        """Original constraint body c(x) -> (B, m_orig)."""
        if self._c_raw is None:
            return self._zeros(x, 0)
        return self._bmap(self._c1, pdata, x)

    def grad_f(self, x, pdata=None):
        """Objective gradient (B, n) (reference eval_grad_f)."""
        return self._bmap(grad(self._f1), pdata, x)

    # ------------------------------------------------------------------
    # canonical constraint vector a(x) >= 0 (reference eval_a)
    def default_bvals(self):
        """Bound values {l, u, lv, uv}, each unbatched (k,)."""
        j = self._j
        return {"l": j["l"], "u": j["u"], "lv": j["lv"], "uv": j["uv"]}

    def shifted_bvals(self, shift):
        """Bound values for the range-shift infeasible generator: the
        constraint bounds lcon/ucon shifted by -shift, the variable bounds
        unchanged.  A scalar `shift` gives unbatched (k,) values; a (B,)
        one (a batch of shifts, the JAX package's vmap over this method)
        gives (B, k) values."""
        j = self._j
        s = torch.as_tensor(shift, dtype=self.dtype, device=self.device)
        if s.dim() == 0:
            return {"l": j["l"] - s, "u": j["u"] - s,
                    "lv": j["lv"], "uv": j["uv"]}
        B = s.shape[0]
        s = s[:, None]
        return {"l": j["l"] - s, "u": j["u"] - s,
                "lv": j["lv"].expand(B, -1), "uv": j["uv"].expand(B, -1)}

    def a_of(self, x, cvals=None, bvals=None, pdata=None):
        b = bvals if bvals is not None else self._j
        j = self._j
        if cvals is None:
            cvals = self.c(x, pdata)
        return torch.cat([
            cvals[:, j["li"]] - b["l"],
            b["u"] - cvals[:, j["ui"]],
            x[:, j["lvi"]] - b["lv"],
            b["uv"] - x[:, j["uvi"]],
        ], dim=-1)

    def jprod_from(self, jc_v, v):
        """Canonical J @ v given the original-Jacobian action jc_v."""
        j = self._j
        return torch.cat([jc_v[:, j["li"]], -jc_v[:, j["ui"]],
                          v[:, j["lvi"]], -v[:, j["uvi"]]], dim=-1)

    def jprod(self, x, v, pdata=None):
        """Canonical J(x) @ v via one JVP on c."""
        if self.m_orig > 0:
            jc_v = self._bmap(lambda xx, vv, pd: jvp(
                lambda z: self._c1(z, pd), (xx,), (vv,))[1], pdata, x, v)
        else:
            jc_v = self._zeros(x, 0)
        return self.jprod_from(jc_v, v)

    def split_canonical(self, w):
        """Canonical multiplier w (B, m) -> (orig-constraint weights
        (B, m_orig), bound vector (B, n))."""
        j = self._j
        nl, nu, nbl = self.n_lcon, self.n_ucon, self.n_lvar
        B = w.shape[0]
        wc = torch.zeros(B, self.m_orig, dtype=w.dtype, device=w.device)
        wc = wc.index_add(1, j["li"], w[:, :nl])
        wc = wc.index_add(1, j["ui"], -w[:, nl:nl + nu])
        bnd = torch.zeros(B, self.n, dtype=w.dtype, device=w.device)
        bnd = bnd.index_add(1, j["lvi"], w[:, nl + nu:nl + nu + nbl])
        bnd = bnd.index_add(1, j["uvi"], -w[:, nl + nu + nbl:])
        return wc, bnd

    def split_canonical_sq(self, d):
        """Like split_canonical with squared signs (J^T diag(d) J)."""
        j = self._j
        nl, nu, nbl = self.n_lcon, self.n_ucon, self.n_lvar
        B = d.shape[0]
        wc = torch.zeros(B, self.m_orig, dtype=d.dtype, device=d.device)
        wc = wc.index_add(1, j["li"], d[:, :nl])
        wc = wc.index_add(1, j["ui"], d[:, nl:nl + nu])
        bnd = torch.zeros(B, self.n, dtype=d.dtype, device=d.device)
        bnd = bnd.index_add(1, j["lvi"], d[:, nl + nu:nl + nu + nbl])
        bnd = bnd.index_add(1, j["uvi"], d[:, nl + nu + nbl:])
        return wc, bnd

    def _vjp_c(self, x, wc, pdata=None, hi=False):
        return self._bmap(lambda xx, ww, pd: vjp(
            lambda z: self._c1(z, pd), xx)[1](ww)[0], pdata, x, wc, hi=hi)

    def jtprod(self, x, w, pdata=None):
        """Canonical J(x)^T @ w via one VJP on c."""
        wc, bnd = self.split_canonical(w)
        if self.m_orig > 0:
            out = self._vjp_c(x, wc, pdata)
        else:
            out = self._zeros(x, self.n)
        return out + bnd

    def c_jtprod(self, x, wcs, pdata=None):
        """c(x) and the original-row products J_c(x)^T wc for every wc in
        `wcs` (each (B, m_orig)), from one forward pass of c.  The line
        search's trial point needs c, J^T y, J^T dy and J^T 1 together."""
        W = torch.stack(wcs, dim=1)                      # (B, k, m_orig)
        cval, jt = self._bmap(self._c_jtw1, pdata, x, W)
        return cval, [jt[:, i] for i in range(len(wcs))]

    def _mu_th(self, mu_th, x):
        t = torch.as_tensor(mu_th, dtype=torch.float64, device=x.device)
        return t[:, None] if t.dim() == 1 else t

    def grad_lag_hi(self, x, w, mu_th, pdata=None):
        """g(x) - J(x)^T w + mu_th * J(x)^T 1, evaluated in float64."""
        hi = torch.float64
        x64 = x.to(hi)
        mt = self._mu_th(mu_th, x)
        g = self._bmap(grad(self._f1), pdata, x64, hi=True)
        wc, bnd = self.split_canonical(w.to(hi))
        th_vec = mt * self._wc_ones_hi - wc
        if self.m_orig > 0:
            jt = self._vjp_c(x64, th_vec, pdata, hi=True)
        else:
            jt = self._zeros(x64, self.n)
        return g + jt + mt * self._bnd_ones_hi - bnd

    def jtprod_hi(self, x, w, pdata=None):
        """Canonical J(x)^T @ w with float64 VJP arithmetic."""
        hi = torch.float64
        x64 = x.to(hi)
        wc, bnd = self.split_canonical(w.to(hi))
        if self.m_orig > 0:
            out = self._vjp_c(x64, wc, pdata, hi=True)
        else:
            out = self._zeros(x64, self.n)
        return out + bnd

    def a_of_hi(self, x, bvals=None, pdata=None):
        """Canonical a(x) in float64."""
        hi = torch.float64
        x64 = x.to(hi)
        if self._c_raw is None:
            cv = self._zeros(x64, 0)
        else:
            cv = self._bmap(self._c1, pdata, x64, hi=True)
        b = bvals if bvals is not None else self._j
        b = {k: b[k].to(hi) for k in ("l", "u", "lv", "uv")}
        return self.a_of(x64, cv, b)

    def jtprod_ones(self, x, pdata=None):
        """Canonical J(x)^T @ 1 (regularizer gradient)."""
        if self.m_orig > 0:
            out = self._vjp_c(x, self._wc_ones.to(x.dtype).expand(
                x.shape[0], -1), pdata)
        else:
            out = self._zeros(x, self.n)
        return out + self._bnd_ones.to(x.dtype)

    # ------------------------------------------------------------------
    # materialized original Jacobian (B, m_orig, n)
    def jac_orig(self, x, pdata=None):
        if self.m_orig == 0:
            return torch.zeros(x.shape[0], 0, self.n, dtype=x.dtype,
                               device=x.device)
        if self._jac_raw is not None:
            # the user Jacobian oracle (full-variable space)
            return self._bmap(self._jac1, pdata, x)
        # forward mode costs n passes, reverse costs m_orig: pick the cheaper
        # (torch.func's forward mode returns float64 for a float32 term
        # such as z - 2.0: the result is cast back, a no-op in float64)
        jac = jacrev if self.m_orig < self.n else jacfwd
        return self._bmap(jac(self._c1), pdata, x).to(x.dtype)

    # canonical products through a materialized Jc, shared (m_orig, n) or
    # batched (B, m_orig, n)
    def jprod_mat(self, Jc, v):
        jc_v = _mv(Jc, v) if self.m_orig > 0 else self._zeros(v, 0)
        return self.jprod_from(jc_v, v)

    def jtprod_mat(self, Jc, w):
        wc, bnd = self.split_canonical(w)
        out = _mtv(Jc, wc) if self.m_orig > 0 else self._zeros(w, self.n)
        return out + bnd

    def jac_canonical(self, Jc):
        """The canonical Jacobian [Jc[li]; -Jc[ui]; I_l; -I_u] (m, n), or
        (B, m, n) from a batched Jc (reference eval_jac,
        Class_cutest.jl:451-503): the symmetric KKT paths only; the Schur
        paths never form it."""
        j = self._j
        eye = torch.eye(self.n, dtype=Jc.dtype, device=Jc.device)
        lead = Jc.shape[:-2]
        return torch.cat([
            Jc.index_select(-2, j["li"]), -Jc.index_select(-2, j["ui"]),
            eye[j["lvi"]].expand(*lead, -1, -1),
            -eye[j["uvi"]].expand(*lead, -1, -1)], -2)

    def jtdj_diag(self, Jc, d):
        """diag(J^T diag(d) J) (B, n) for d (B, m) and a shared or batched
        Jc (reference eval_diag_J_T_J, eval.jl:88-99)."""
        wc, bnd = self.split_canonical_sq(d)
        if self.m_orig == 0:
            return bnd
        if Jc.dim() == 2:
            return wc @ (Jc * Jc) + bnd
        return torch.einsum("bij,bi,bij->bj", Jc, wc, Jc) + bnd

    def jtdj(self, Jc, d):
        """Canonical J^T diag(d) J (B, n, n) = Jc^T diag(wc) Jc + diag(bnd)
        with wc/bnd from the sign-squared scatter (reference eval_J_T_J,
        eval.jl:84-86)."""
        wc, bnd = self.split_canonical_sq(d)
        if self.m_orig > 0:
            Q = (Jc * wc[:, :, None]).transpose(-1, -2) @ Jc
        else:
            Q = torch.zeros(d.shape[0], self.n, self.n, dtype=d.dtype,
                            device=d.device)
        return Q + torch.diag_embed(bnd)

    def jtdj_fused(self, Jc, d, H, use_pallas: bool = False,
                   mxu_dtype=None):
        """Q = H + J^T diag(d) J (B, n, n), fused: the hand kernel on the
        pallas lane (ops/schur.py).  `mxu_dtype` (torch.bfloat16) forms the
        rank-m update from bf16 operands with float32 accumulation."""
        from .ops.schur import fused_q
        wc, bnd = self.split_canonical_sq(d)
        return fused_q(Jc, wc, H, bnd, use_pallas, mxu_dtype)

    # ------------------------------------------------------------------
    # Lagrangian Hessian of f(x) - y^T a(x), materialized (B, n, n)
    def _lag1(self, x, wc, pd=None):
        val = self._f1(x, pd)
        if self.m_orig > 0:
            # a product and a sum, not torch.dot: in a float32 solve
            # torch.func's forward mode gives a term such as z - 2.0 a
            # float64 tangent, which a dot refuses; the derivatives are the
            # same values
            val = val - (wc * self._c1(x, pd)).sum()
        return val

    def lag_hess(self, x, y, pdata=None):
        wc, _ = self.split_canonical(y)
        return self._bmap(hessian(self._lag1), pdata, x, wc).to(x.dtype)

    def hess_prod_fn(self, x, y, pdata=None):
        """Returns v (B, n) -> H v, the Lagrangian-Hessian product at fixed
        (x, y): forward-over-reverse, no (n, n) matrix."""
        wc, _ = self.split_canonical(y)

        def hv1(xx, ww, vv, pd):
            return jvp(grad(lambda z: self._lag1(z, ww, pd)), (xx,),
                       (vv,))[1]

        return lambda v: self._bmap(hv1, pdata, x, wc, v).to(x.dtype)


def canonicalize(spec: NLPSpec, dtype=torch.float64, device=None) -> CanonNLP:
    """Canonicalize `spec` for solves in `dtype` on `device` (default: the
    CUDA card; without one, pass device="cpu").  float64 is the default
    dtype, as in the JAX package under x64."""
    return CanonNLP(spec, dtype=dtype, device=device)
