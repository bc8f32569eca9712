"""RCM-banded one-phase IPM: general unstructured sparsity.

Port of onephase_tpu/parallel/banded.py.  Instead of a general sparse
factorization, the structural pattern of Q = H + J' D J is reverse
Cuthill-McKee reordered ONCE at construction (host-side symbolic analysis,
`native.rcm_order`).  A banded matrix with bandwidth <= nb IS
block-tridiagonal with (nb, nb) dense blocks, so the permuted Q is
assembled directly in block-band form and factored by the block-tridiagonal
code of the chain path at O(K nb^3): the (n, n) dense Q is never formed.

Two modes:

- assembled (default): J (m_orig, n) and H (n, n) are evaluated densely and
  their band is gathered, O(m n nb);
- `matrix_free=True`: neither a dense J nor a dense H ever exists.  The
  band of the Schur operator S(v) = H v + J'(wc * (J v)) + bnd * v is probed
  with G nb operator applications (G = min(3, K) block colors), and the
  Factor's `Jc` slot carries the factorization point x (B, n), its `H` slot
  mu (B,): every J/H product of the direction and the refinement is an
  autodiff oracle call.  Memory is O(n nb).

Batch-first like the rest of the port: blocks are (B, K, nb, nb); the
permutation, the probes and the identity tail are shared by the instances.
Lanes (`kkt.linear_solver_type`), as on the chain path:

- `pallas`: the factor is (Ci, Ek); on the card one launch of the hand
  kernel K7 per delta attempt and one of K5 per backsolve
  (ops/tridiag_pallas.py), on the CPU their plain versions
  (`tridiag_factor` + `block_inverses`, the JAX package's hybrid);
- `xla`: (Ck, Ek) from `tridiag_factor`, solved by `tridiag_solve`; with
  `kkt.chain_partitions` > 1 the nested-dissection pair.

Pattern caveat: the structure is detected from |J|/|H| at sample points at
construction; entries zero at every sample but nonzero elsewhere would be
dropped (the usual AD-structure assumption).  At scales where even one dense
J does not fit, pass the `pattern`.  Problems whose RCM bandwidth approaches
n gain nothing: use the dense `OnePhaseKernel` there.  A parametric problem
(`NLPSpec.pdata`) takes its pattern from `sample_pdata` (one instance's
data; default: the spec's template) and its per-instance data from the
state, as in the JAX kernel; the matrix-free mode refuses it, as the JAX
kernel does.  With a `mesh` (parallel/mesh.py, axis "chain") the
partitions of the nested-dissection factor are sharded over its ranks, as
on the chain path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, jvp, vjp, vmap

from ..config import Params
from ..ipm.core import OnePhaseKernel, _c
from ..ipm.state import Cache, Factor, Point
from ..native import rcm_order
from ..nlp import CanonNLP, resolve_device
from ..ops.block_tridiag import (TridiagFactor, check_mesh_partitions,
                                 partitioned_factor,
                                 partitioned_solve, tridiag_factor,
                                 tridiag_solve)
from ..ops.tridiag_pallas import pallas_tridiag_factor, pallas_tridiag_solve
from .mesh import check_mesh_device


def _structural_pattern(nlp: CanonNLP, n_samples: int,
                        pdata=None) -> np.ndarray:
    """Union of the |J'J| and |H| nonzero patterns at sample points (the
    start, then perturbations of it drawn from a fixed seed) of one
    instance (`pdata`: its data, default the template); (n, n) bool on the
    host."""
    rng = np.random.default_rng(0)
    pd = (None if pdata is None else
          {k: v[None] for k, v in nlp.pdata_to(pdata).items()})
    x0 = np.asarray(nlp.x0, np.float64)
    pat = np.eye(nlp.n, dtype=bool)

    def dev(a):
        return torch.as_tensor(a, dtype=nlp.dtype, device=nlp.device)[None]

    for i in range(max(1, n_samples)):
        if i == 0:
            x = x0
        else:
            x = x0 * (1.0 + 0.01 * rng.standard_normal(nlp.n)) \
                + 0.01 * rng.standard_normal(nlp.n)
        y = rng.uniform(0.5, 1.5, nlp.m)
        if nlp.m_orig > 0:
            Bm = (nlp.jac_orig(dev(x), pd)[0] != 0).to(torch.float32)
            # counts of shared rows: exact in float32 below 2^24 rows
            pat |= (Bm.T @ Bm).cpu().numpy() > 0
        pat |= (nlp.lag_hess(dev(x), dev(y), pd)[0] != 0).cpu().numpy()
    return pat


def _block_diagonals(Mb):
    """Mb (B, K, nb, K, nb) -> its diagonal blocks (B, K, nb, nb) and the
    blocks below them [k + 1, :, k, :] (B, K-1, nb, nb)."""
    Qd = torch.diagonal(Mb, dim1=1, dim2=3).movedim(-1, 1)
    Qs = torch.diagonal(Mb, offset=-1, dim1=1, dim2=3).movedim(-1, 1)
    return Qd, Qs


class BandedKernel(OnePhaseKernel):
    """OnePhaseKernel whose Schur complement is RCM-banded block-tridiag.

    `block_size` overrides the detected bandwidth (must be >= it).
    `pattern` ((n, n) bool, the structural nonzeros of H + J'J) skips the
    sample-based detection.  With `pars.kkt.chain_partitions > 1` the band
    factors by nested dissection, its partitions sharded over the
    `chain_axis` of `mesh` when one is given.  `device` defaults to the
    CUDA card and must be where `nlp` lives (and be the mesh's device).
    """

    def __init__(self, nlp: CanonNLP, pars: Params, block_size: int = None,
                 n_samples: int = 2, sample_pdata=None, mesh=None,
                 chain_axis: str = "chain", matrix_free: bool = False,
                 pattern: np.ndarray = None, device=None):
        if pars.kkt.kkt_solver_type != "schur":
            raise ValueError("BandedKernel implements the schur path only")
        if pars.kkt.linear_solver_type not in ("xla", "pallas"):
            raise ValueError("BandedKernel has its own block solve path; "
                             "set kkt.linear_solver_type='xla' (sequential "
                             "block recursion) or 'pallas' (the K5/K7 "
                             "kernels)")
        self.use_pallas = pars.kkt.linear_solver_type == "pallas"
        self.partitions = int(pars.kkt.chain_partitions)
        if self.use_pallas and self.partitions > 1:
            raise ValueError("pallas tridiag backend is sequential; "
                             "incompatible with chain_partitions > 1")
        if pars.kkt.factor_precision != "same":
            raise ValueError("BandedKernel supports factor_precision='same'")
        if matrix_free:
            if pars.kkt.it_refine_highprec:
                raise ValueError("matrix_free mode has no materialized J/H "
                                 "for the double-single residual path")
            if nlp.parametric:
                raise ValueError("matrix_free mode supports non-parametric "
                                 "problems (pdata-free oracles)")
        if mesh is not None:
            check_mesh_partitions(self.partitions, mesh, chain_axis)
        self.mesh = mesh
        device = resolve_device(device)
        check_mesh_device(mesh, device)
        if nlp.device.type != device.type:
            raise ValueError(f"the problem lives on {nlp.device}, the kernel "
                             f"was asked for {device}")
        self.matrix_free = matrix_free
        self._skip_const_fold = matrix_free
        super().__init__(nlp, pars)

        # host-side symbolic analysis: RCM ordering + bandwidth
        if pattern is None:
            pattern = _structural_pattern(nlp, n_samples, sample_pdata)
        pattern = np.asarray(pattern)
        if pattern.shape != (nlp.n, nlp.n):
            raise ValueError(f"pattern has shape {pattern.shape}, expected "
                             f"{(nlp.n, nlp.n)}")
        perm = np.asarray(rcm_order(pattern), np.int64)
        ii, jj = np.nonzero(pattern[perm][:, perm])
        bw = int(np.abs(ii - jj).max()) if ii.size else 1
        nb = int(block_size) if block_size is not None else max(bw, 1)
        if nb < bw:
            raise ValueError(f"block_size {nb} < RCM bandwidth {bw}")
        K = -(-nlp.n // nb)
        if self.partitions > 1:
            # partitioned factor needs K = P * Kc with Kc >= 2
            K = self.partitions * max(2, -(-K // self.partitions))
        self.nb, self.K, self.n_pad = nb, K, K * nb
        self.bandwidth = bw
        self.perm = perm
        self.iperm = np.argsort(perm)
        # device copies, built once: no host round trip per backsolve
        self._perm_t = torch.as_tensor(self.perm, device=self.device)
        self._iperm_t = torch.as_tensor(self.iperm, device=self.device)
        # identity on the padded tail of the permuted diagonal (K, nb)
        self._tail_diag = (torch.arange(self.n_pad, device=self.device)
                           >= nlp.n).to(self.dtype).reshape(K, nb)

        if matrix_free:
            # probing basis for band extraction: G = min(3, K) block colors;
            # same-color blocks are >= 3 apart, so the +-1-block reads of
            # one source block cannot overlap another source's band
            # (bandwidth <= nb by construction).  G*nb operator
            # applications recover the exact (Qd, Qs) block band.
            G = min(3, K)
            j = torch.arange(nlp.n, device=self.device)
            P = torch.zeros(G, nb, nlp.n, dtype=self.dtype,
                            device=self.device)
            P[(j // nb) % G, j % nb, self._perm_t] = 1.0
            self._probes = P.reshape(G * nb, nlp.n)
            self._ncolors = G
            kk = torch.arange(K, device=self.device)
            self._block_idx, self._color_idx = kk, kk % G

    # ---------------- matrix-free product hooks ----------------------
    # In matrix_free mode the Factor never holds a dense J or H: the Jc
    # slot carries the factorization point x (B, n), the H slot mu (B,).
    # With the stored y_f these reconstruct the exact linearization point,
    # and all products are autodiff oracle calls.
    def fact_jprod(self, fact, v):
        if not self.matrix_free:
            return super().fact_jprod(fact, v)
        return self.nlp.jprod(fact.Jc, v)

    def fact_jtprod(self, fact, w):
        if not self.matrix_free:
            return super().fact_jtprod(fact, w)
        return self.nlp.jtprod(fact.Jc, w)

    def fact_hmul(self, fact, v):
        if not self.matrix_free:
            return super().fact_hmul(fact, v)
        y_eff = fact.y_f + _c(fact.H * self.pars.a_norm_penalty)
        return self.nlp.hess_prod_fn(fact.Jc, y_eff)(v)

    # ---------------- banded assembly --------------------------------
    def _pad_perm(self, M, dims):
        """Permute the trailing dims `dims` (negative) of M by perm and
        zero-pad them from n to n_pad."""
        for d in dims:
            M = M.index_select(d, self._perm_t)
        pad = self.n_pad - self.n
        if pad:
            spec = [0, 0] * max(-d for d in dims)
            for d in dims:
                spec[2 * (-d - 1) + 1] = pad
            M = F.pad(M, spec)
        return M

    def _banded_blocks(self, H, Jc, wc, bnd):
        """(Qd, Qs) block bands of P (H + J' diag(wc) J + diag(bnd)) P',
        (B, K, nb, nb) and (B, K-1, nb, nb).  H is None, shared (n, n) or
        (B, n, n); Jc shared (m_orig, n) or (B, m_orig, n)."""
        K, nb = self.K, self.nb
        B = bnd.shape[0]
        diag = self._pad_perm(bnd, [-1]).reshape(B, K, nb) + self._tail_diag
        if H is None:
            Qd = torch.diag_embed(diag)
            Qs = bnd.new_zeros(B, K - 1, nb, nb)
        else:
            Hp = self._pad_perm(H.expand(B, self.n, self.n), [-2, -1])
            Qd, Qs = _block_diagonals(Hp.reshape(B, K, nb, K, nb))
            Qd = Qd + torch.diag_embed(diag)
        if self.nlp.m_orig > 0:
            Jb = self._pad_perm(Jc, [-1]).reshape(
                Jc.shape[:-1] + (K, nb)).expand(B, -1, K, nb)
            JW = Jb * wc[:, :, None, None]
            Qd = Qd + torch.einsum("bmki,bmkj->bkij", JW, Jb)
            if K > 1:
                Qs = Qs + torch.einsum("bmki,bmkj->bkij", JW[:, :, 1:],
                                       Jb[:, :, :-1])
        # the kernels take row-major blocks
        return Qd.contiguous(), Qs.contiguous()

    def _schur_diag(self, Qd):
        """diag(Q) in the original variable order, the n real entries (same
        multiset as the dense kernel's, without the identity tail), so the
        tau test and the zero-delta try of the delta search behave as on
        the dense path."""
        d = torch.diagonal(Qd, dim1=-2, dim2=-1).reshape(Qd.shape[0], -1)
        return d.index_select(1, self._iperm_t)

    # ---------------- overridden KKT path ----------------------------
    def _form_factor_matrix_free(self, p: Point, prev: Factor) -> Factor:
        """Probe the Schur operator S(v) = H v + J'(wc*(J v)) + bnd*v for
        its block-tridiagonal band: G*nb oracle applications per instance,
        batched by vmap; no dense J (m, n) or H (n, n) ever exists.  The
        band blocks are exact (nb >= bandwidth, as for the assembly)."""
        nlp = self.nlp
        K, nb, n = self.K, self.nb, self.n
        G = self._ncolors
        B = p.x.shape[0]
        y_eff = p.y + _c(p.mu * self.pars.a_norm_penalty)
        wc_y, _ = nlp.split_canonical(y_eff)
        wc, bnd = nlp.split_canonical_sq(p.y / p.s)
        probes = self._probes

        def band_products(x, wy, w, bd):
            """S(v) for every probe v, one instance: (G*nb, n)."""
            glag = grad(lambda z: nlp._lag1(z, wy))
            if nlp.m_orig > 0:
                _, pull = vjp(nlp._c1, x)

            def S_op(v):
                out = jvp(glag, (x,), (v,))[1] + bd * v
                if nlp.m_orig > 0:
                    jv = jvp(nlp._c1, (x,), (v,))[1]
                    out = out + pull(w * jv)[0]
                return out

            return vmap(S_op)(probes)

        V = vmap(band_products)(p.x, wc_y, wc, bnd)       # (B, G*nb, n)
        # [b, color, r, block, i] in permuted coordinates
        Vb = self._pad_perm(V, [-1]).reshape(B, G, nb, K, nb)
        # block k's columns were probed by color k % G: Vk[b, k, color]
        Vk = Vb.permute(0, 3, 1, 2, 4)                    # (B, K, G, r, i)
        kk, cc = self._block_idx, self._color_idx
        Qd = Vk[:, kk, cc].transpose(-1, -2)              # (B, K, i, r)
        Qd = Qd + torch.diag_embed(self._tail_diag)
        if K > 1:
            Qs = Vk[:, kk[1:], cc[:-1]].transpose(-1, -2)
        else:
            Qs = V.new_zeros(B, 0, nb, nb)
        Qd, Qs = Qd.contiguous(), Qs.contiguous()
        return Factor(Jc=p.x, H=p.mu, Q=(Qd, Qs),
                      schur_diag=self._schur_diag(Qd),
                      L=prev.L, D=prev.D, delta=prev.delta,
                      s_f=p.s, y_f=p.y, ok=torch.zeros_like(prev.ok))

    def form_factor(self, p: Point, cache: Cache, prev: Factor,
                    pdata=None) -> Factor:
        if self.matrix_free:
            return self._form_factor_matrix_free(p, prev)
        nlp = self.nlp
        y_eff = p.y + _c(p.mu * self.pars.a_norm_penalty)
        H, Jc = self._factor_point_jh(p, prev, y_eff, pdata)
        wc, bnd = nlp.split_canonical_sq(p.y / p.s)
        Qd, Qs = self._banded_blocks(H, Jc, wc, bnd)
        return Factor(Jc=self._store_jc(Jc), H=self._store_h(H), Q=(Qd, Qs),
                      schur_diag=self._schur_diag(Qd),
                      L=prev.L, D=prev.D, delta=prev.delta,
                      s_f=p.s, y_f=p.y, ok=torch.zeros_like(prev.ok))

    def finalize_solver(self, L):
        # the structured factor IS the solve operator (block tuple)
        return L

    def factor(self, Q, delta, rescale=None, fact=None):
        Qd, Qs = Q
        D = Qd.new_zeros(Qd.shape[0], 1)
        if self.partitions > 1:
            pf = partitioned_factor(Qd, Qs, delta, self.partitions,
                                    self.mesh)
            return (pf, D), pf.ok
        if self.use_pallas:
            _, Ci, Ek, ok = pallas_tridiag_factor(Qd, Qs, delta)    # K7
            return ((Ci, Ek), D), ok
        f = tridiag_factor(Qd, Qs, delta)
        return ((f.Ck, f.Ek), D), f.ok

    def chol_solve(self, L, b):
        """Permute -> banded block solve -> unpermute; b (B, n)."""
        bp = self._pad_perm(b, [-1]).reshape(b.shape[0], self.K, self.nb)
        if self.partitions > 1:
            xp = partitioned_solve(L, bp, self.mesh)
        elif self.use_pallas:
            xp = pallas_tridiag_solve(L[0], L[1], bp)               # K5
        else:
            xp = tridiag_solve(TridiagFactor(Ck=L[0], Ek=L[1], ok=None), bp)
        return xp.reshape(b.shape[0], -1).index_select(1, self._iperm_t)

    def _empty_factor(self, B) -> Factor:
        """The carried Factor before the first factorization, in block
        form; in matrix-free mode nothing (n, n) or (m, n) is allocated."""
        n, m = self.n, self.m
        K, nb = self.K, self.nb
        dt, dev = self.dtype, self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        eyeK = torch.eye(nb, dtype=dt, device=dev).expand(
            B, K, nb, nb).contiguous()
        zsub = zeros(B, K - 1, nb, nb)
        if self.partitions > 1:
            # identity-block factorization fixes the factor's structure;
            # ok=False marks it stale
            L0 = partitioned_factor(eyeK, zsub, 0.0, self.partitions,
                                    self.mesh)
        else:
            L0 = (eyeK, zsub)
        if self.matrix_free:
            Jc, H = zeros(B, n), zeros(B)        # the x and mu slots
        else:
            Jc = self._store_jc(zeros(B, self.nlp.m_orig, n))
            H = self._store_h(zeros(B, n, n))
        return Factor(Jc=Jc, H=H, Q=(eyeK, zsub), schur_diag=zeros(B, n),
                      L=L0, D=zeros(B, 1), delta=zeros(B),
                      s_f=self._full((B, m), 1.0),
                      y_f=self._full((B, m), 1.0),
                      ok=torch.zeros(B, dtype=torch.bool, device=dev))
