"""Block-tridiagonal Cholesky for chain-structured (OCP-style) KKT systems.

Port of onephase_tpu/ops/block_tridiag.py.  Chain-structured NLPs keep
their Schur complement in block-tridiagonal form

    Q = tridiag(B_{k-1}, A_k, B_k^T),   A_k (nb, nb), B_k = Q[k+1, k]

and factor it with K sequential nb-sized dense Cholesky steps: O(K nb^3)
work and O(K nb^2) memory instead of O((K nb)^3) / O((K nb)^2).

    C_0 = chol(A_0 + delta I)
    E_k = B_k C_k^{-T}                       (subdiagonal of L)
    C_{k+1} = chol(A_{k+1} + delta I - E_k E_k^T)

Inertia rule: correct iff every block Cholesky succeeds (every pivot finite
and > 0) -- the block rule, not the dense path's relative pivot screen.

Every function takes leading batch dimensions: blocks are (..., K, nb, nb)
and right-hand sides (..., K, nb).  One function thus serves the port's
batch axis B and the partition axis P, which the JAX package vmaps.  The
K-step recursions are Python loops (the JAX package's `lax.scan`); these
are the plain versions of the `xla` lane, and the `pallas` lane's kernels
(ops/tridiag_pallas.py) replace them on the card.  The nested-dissection
factor and solve take an optional mesh (parallel/mesh.py): the partition
axis is then sharded over its ranks, as the JAX module's
`shard_partitioned` shards it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TridiagFactor(NamedTuple):
    Ck: torch.Tensor             # (..., K, nb, nb) diagonal Cholesky blocks
    Ek: torch.Tensor             # (..., K-1, nb, nb) subdiagonal blocks of L
    ok: Optional[torch.Tensor]   # (...) bool


def _delta_eye(A, delta):
    """delta I shaped to add to one stage's blocks A (..., nb, nb); delta a
    float or a tensor whose shape is a prefix of A's batch dimensions."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    if isinstance(delta, torch.Tensor):
        delta = delta.to(A.dtype).reshape(
            delta.shape + (1,) * (A.dim() - delta.dim()))
    return delta * eye


def _pivots_ok(Ck, info):
    """Every pivot finite and > 0 (and LAPACK's info == 0) over K blocks."""
    d = torch.diagonal(Ck, dim1=-2, dim2=-1)
    return ((info == 0).all(-1) & torch.isfinite(d).all(-1).all(-1)
            & (d > 0).all(-1).all(-1))


def tridiag_factor(Ad, Bs, delta) -> TridiagFactor:
    """Ad (..., K, nb, nb) diagonal blocks; Bs (..., K-1, nb, nb) subdiagonal
    blocks B_k = Q[k+1, k]; delta added to every diagonal entry."""
    K = Ad.shape[-3]
    dI = _delta_eye(Ad[..., 0, :, :], delta)
    C, info = torch.linalg.cholesky_ex(Ad[..., 0, :, :] + dI)
    Cs, infos, Es = [C], [info], []
    for k in range(1, K):
        # E = B C_prev^{-T}  <=>  E^T = C_prev^{-1} B^T
        Et = torch.linalg.solve_triangular(
            C, Bs[..., k - 1, :, :].transpose(-1, -2), upper=False)
        S = (Ad[..., k, :, :] + dI) - Et.transpose(-1, -2) @ Et
        C, info = torch.linalg.cholesky_ex(S)
        Cs.append(C)
        infos.append(info)
        Es.append(Et.transpose(-1, -2))
    Ck = torch.stack(Cs, dim=-3)
    Ek = (torch.stack(Es, dim=-3) if Es else
          Ad.new_zeros(Ad.shape[:-3] + (0,) + Ad.shape[-2:]))
    return TridiagFactor(Ck, Ek, _pivots_ok(Ck, torch.stack(infos, -1)))


def _tlo(C, r):
    return torch.linalg.solve_triangular(C, r, upper=False)


def _tup(C, r):
    return torch.linalg.solve_triangular(C.transpose(-1, -2), r, upper=True)


def tridiag_solve(f: TridiagFactor, b):
    """Solve L L^T x = b with b (..., K, nb), or with a block of columns
    b (..., K, nb, r) (one more dimension than the factor's blocks); two
    block sweeps."""
    cols = b.dim() == f.Ck.dim()
    R = b if cols else b.unsqueeze(-1)
    K = f.Ck.shape[-3]
    y = [_tlo(f.Ck[..., 0, :, :], R[..., 0, :, :])]
    for k in range(1, K):
        y.append(_tlo(f.Ck[..., k, :, :], R[..., k, :, :]
                      - f.Ek[..., k - 1, :, :] @ y[-1]))
    x = [None] * K
    x[K - 1] = _tup(f.Ck[..., K - 1, :, :], y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = _tup(f.Ck[..., k, :, :], y[k]
                    - f.Ek[..., k, :, :].transpose(-1, -2) @ x[k + 1])
    X = torch.stack(x, dim=-3)
    return X if cols else X.squeeze(-1)


class PartitionedFactor(NamedTuple):
    """Nested-dissection factorization of a block-tridiagonal SPD matrix.

    K = P * Kc stages are split into P chunks; the last stage of each chunk
    is a *separator*.  The Li = Kc-1 interior stages of every chunk factor
    independently (the P axis is a batch axis), leaving a P-block reduced
    tridiagonal system over the separators (sequential).  Elimination order
    is a permutation, so "every block Cholesky succeeds" still certifies
    positive definiteness -- the same inertia rule as `tridiag_factor`.
    Leading batch dimensions (...) precede P.
    """
    interiors: TridiagFactor   # Ck (..., P, Li, nb, nb), Ek (..., P, Li-1, ..)
    Gu: torch.Tensor           # (..., P, Li, nb, nb) = T_p^{-1} u_p
    Gv: torch.Tensor           # (..., P, Li, nb, nb) = T_p^{-1} v_p (v_0 = 0)
    Bu: torch.Tensor           # (..., P, nb, nb) coupling B_{s_p - 1}
    Vs: torch.Tensor           # (..., P, nb, nb) coupling B_{s_{p-1}} (0, p=0)
    red: TridiagFactor         # reduced P-block tridiagonal factor
    ok: torch.Tensor           # (...) bool


def _partition_blocks(Ad, Bs, P):
    """Split (..., K, nb, nb)/(..., K-1, nb, nb) chain blocks into per-chunk
    pieces."""
    K, nb = Ad.shape[-3], Ad.shape[-1]
    lead = Ad.shape[:-3]
    if K % P or K // P < 2:
        raise ValueError(f"K={K} must be P*Kc with Kc>=2 (P={P})")
    Kc = K // P
    Li = Kc - 1
    zero = Bs.new_zeros(lead + (1, nb, nb))
    Adc = Ad.reshape(lead + (P, Kc, nb, nb))
    Bc = torch.cat([Bs, zero], dim=-3).reshape(lead + (P, Kc, nb, nb))
    Ai = Adc[..., :Li, :, :]                 # interior diagonal blocks
    Ei = Bc[..., :Li - 1, :, :]              # (.., P, 0, nb, nb) when Li = 1
    Asep = Adc[..., -1, :, :]                # separator diagonal blocks
    Bu = Bc[..., Li - 1, :, :]               # B_{s_p - 1}: interior -> own sep
    # v_p = B_{s_{p-1}} couples chunk p's first interior stage to sep p-1
    Vs = torch.cat([zero, Bc[..., :-1, -1, :, :]], dim=-3)
    return Kc, Li, Ai, Ei, Asep, Bu, Vs


def check_mesh_partitions(partitions: int, mesh, axis: str) -> None:
    """Validate a partition-axis sharding request up front (the JAX
    package's checks and messages): a mesh needs `kkt.chain_partitions`
    > 1, an axis of that name and P divisible by its size."""
    if partitions <= 1:
        raise ValueError("a mesh requires kkt.chain_partitions > 1")
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes: "
                         f"{tuple(mesh.shape)})")
    size = mesh.shape[axis]
    if partitions % size:
        raise ValueError(
            f"kkt.chain_partitions={partitions} must be divisible by the "
            f"mesh {axis!r} axis size {size}")


def _gather(mesh, local, dim):
    """The full partition stack (identity without a mesh)."""
    return local if mesh is None else mesh.gather(local, dim)


def partitioned_factor(Ad, Bs, delta, P, mesh=None) -> PartitionedFactor:
    """Factor tridiag(B, A, B^T) + delta*I with P chunks (batched over P).

    With a `mesh` (parallel/mesh.Mesh; Ad and Bs replicated on every rank)
    each rank factors its P/D chunks' interiors; the per-chunk coupling
    terms are gathered (Mesh.gather, exact) and the reduced P-block system
    is factored on every rank.  The interiors, Gu, Gv, Bu and Vs of the
    result are the rank's own chunks; `red` and `ok` are replicated."""
    nb = Ad.shape[-1]
    Kc, Li, Ai, Ei, Asep, Bu, Vs = _partition_blocks(Ad, Bs, P)
    if mesh is not None:
        lo, hi = mesh.rows(P)
        Ai, Ei = Ai[..., lo:hi, :, :, :], Ei[..., lo:hi, :, :, :]
        Bu, Vs = Bu[..., lo:hi, :, :], Vs[..., lo:hi, :, :]
    interiors = tridiag_factor(Ai, Ei, delta)

    U = Ad.new_zeros(Ai.shape)
    U[..., Li - 1, :, :] = Bu.transpose(-1, -2)
    V = Ad.new_zeros(Ai.shape)
    V[..., 0, :, :] = Vs
    Gu = tridiag_solve(interiors, U)
    Gv = tridiag_solve(interiors, V)

    # the chunks' coupling terms, each (..., P, nb, nb) on every rank:
    # u_p' T_p^-1 u_p, v_p' T_p^-1 v_p and u_p' T_p^-1 v_p
    UGu = _gather(mesh, torch.einsum("...pij,...pjk->...pik",
                                     Bu, Gu[..., -1, :, :]), -3)
    W = _gather(mesh, torch.einsum("...pji,...pjk->...pik",
                                   Vs, Gv[..., 0, :, :]), -3)
    UGv = _gather(mesh, torch.einsum("...pij,...pjk->...pik",
                                     Bu, Gv[..., -1, :, :]), -3)
    zero = Ad.new_zeros(Asep.shape[:-3] + (1, nb, nb))
    # S[p,p] = A_sep[p] + dI - u_p' T_p^-1 u_p - v_{p+1}' T_{p+1}^-1 v_{p+1}
    Wnext = torch.cat([W[..., 1:, :, :], zero], dim=-3)
    S_dd = Asep + _delta_eye(Asep, delta) - UGu - Wnext
    # S[p, p-1] = -u_p' T_p^-1 v_p
    S_sub = -UGv[..., 1:, :, :]
    red = tridiag_factor(S_dd, S_sub, 0.0)
    ok = _gather(mesh, interiors.ok, -1).all(-1) & red.ok
    return PartitionedFactor(interiors=interiors, Gu=Gu, Gv=Gv, Bu=Bu,
                             Vs=Vs, red=red, ok=ok)


def partitioned_solve(f: PartitionedFactor, b, mesh=None):
    """Solve with b (..., K, nb); interiors batched over P, reduced
    sequential.  With a `mesh` (the factor's; b replicated) each rank
    solves its own chunks' interiors, and the separators' right-hand side
    and the interior solutions are gathered: x is replicated."""
    Pl, Li, nb = f.Gu.shape[-4], f.Gu.shape[-3], f.Gu.shape[-1]
    P = Pl if mesh is None else Pl * mesh.size
    Kc = Li + 1
    lead = b.shape[:-2]
    bc = b.reshape(lead + (P, Kc, nb))
    bi, bsep = bc[..., :Li, :], bc[..., -1, :]
    if mesh is not None:
        lo, hi = mesh.rows(P)
        bi = bi[..., lo:hi, :, :]

    yi = tridiag_solve(f.interiors, bi)
    zero = b.new_zeros(lead + (1, nb))
    Z = _gather(mesh, torch.einsum("...pji,...pj->...pi", f.Vs,
                                   yi[..., 0, :]), -2)
    Uy = _gather(mesh, torch.einsum("...pij,...pj->...pi", f.Bu,
                                    yi[..., -1, :]), -2)
    Znext = torch.cat([Z[..., 1:, :], zero], dim=-2)
    rs = bsep - Uy - Znext
    xs = tridiag_solve(f.red, rs)

    xs_prev = torch.cat([zero, xs[..., :-1, :]], dim=-2)
    xs_own, xs_prev_own = xs, xs_prev
    if mesh is not None:
        xs_own, xs_prev_own = xs[..., lo:hi, :], xs_prev[..., lo:hi, :]
    xi = (yi - torch.einsum("...pkij,...pj->...pki", f.Gu, xs_own)
          - torch.einsum("...pkij,...pj->...pki", f.Gv, xs_prev_own))
    xi = _gather(mesh, xi, -3)
    return torch.cat([xi, xs.unsqueeze(-2)], dim=-2).reshape(
        lead + (P * Kc, nb))


def tridiag_matvec(Ad, Bs, v):
    """Block-tridiagonal matvec: (Q v)_k = A_k v_k + B_{k-1} v_{k-1}
    + B_k^T v_{k+1}; v (..., K, nb)."""
    out = torch.einsum("...kij,...kj->...ki", Ad, v)
    if Bs.shape[-3]:
        lower = torch.einsum("...kij,...kj->...ki", Bs, v[..., :-1, :])
        upper = torch.einsum("...kji,...kj->...ki", Bs, v[..., 1:, :])
        out[..., 1:, :] += lower
        out[..., :-1, :] += upper
    return out
