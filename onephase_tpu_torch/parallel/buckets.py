"""Shape-class bucketing: a heterogeneous LP sweep as a few padded batches.

Port of onephase_tpu/parallel/buckets.py.  A directory of LPs with
different shapes is solved as a handful of batches:

1. eliminate fixed variables per instance (the reference's `_i_not_fixed`
   canonicalization step, Class_cutest.jl:37-48, done on the data here),
2. pad every instance to a shape-class (n, m rounded up) with neutral
   variables/rows and all-finite bounds (missing bound sides -> +-BIG),
   so the canonical row PATTERN is identical across a bucket,
3. per-instance (A, c, c0) become parametric pdata and per-instance bound
   values become bvals: one kernel per bucket (nlp.NLPSpec.pdata), whose
   Schur path forms Q from a (B, m, n) Jacobian (each instance its own A),
4. run each bucket through `BatchSolver` with masked per-instance
   termination, and de-pad the results.

Padding is exact: pad variables have zero objective and zero matrix columns
(bounds [-1, 1]), pad rows are 0^T x in [-1, 1]; the +-BIG bound rows are
never active for problems whose solutions are < BIG in norm.

Float64 escalation (`escalate_f64`): instances that end MAX_IT, MAX_DELTA
or STALLED under a float32 solve get one float64 pass with `term.max_it`
capped at 80, and are marked `escalated`.  The JAX package sends that pass
to the host CPU because the TPU emulates float64; the H100 has native
float64, so the port runs the escalation pass on the same device as the
float32 pass (on the card when the caller's device is the card).  The
numpy pieces (`eliminate_fixed`, `equilibrate_rows`, `pad_lp`,
`bucket_shapes`) are the JAX package's, copied unchanged
(tests/test_torch_config.py pins them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Params
from ..ipm.history import IDX
from ..ipm.state import STATUS_NAMES
from ..models.lp import LPData
from ..nlp import NLPSpec, canonicalize, resolve_device
from .batch import BatchSolver

BIG = 1e8
ESCALATE_MAX_IT = 80


def _round_up(x, m):
    return int(-(-x // m) * m)


@dataclass
class _Instance:
    """Bookkeeping for one problem inside a bucket."""

    name: str
    n_true: int            # free (post-elimination) variable count
    x_fixed: np.ndarray    # full-variable template with fixed values
    free_idx: np.ndarray
    c0: float


@dataclass
class BucketResult:
    status: str
    obj: float
    x: np.ndarray          # full-variable primal solution
    iterations: int
    max_violation: float
    name: str = ""
    # final-iterate metrics from the last history row (the ring keeps the
    # latest record even at batch_history_capacity=2)
    dual_feas: float = float("nan")
    comp: float = float("nan")
    # resolved by the f64 escalation pass (solve_bucketed escalate_f64)
    escalated: bool = False


def eliminate_fixed(d: LPData, tol: float = 0.0) -> Tuple[LPData, np.ndarray, np.ndarray]:
    """Fold variables with lvar == uvar into the constraint bounds / offset.

    Returns (reduced LPData, full template x with fixed values, free idx).
    """
    fixed = d.lvar == d.uvar
    if not fixed.any():
        return d, np.array(d.lvar, dtype=float) * 0.0, np.arange(d.n)
    free = ~fixed
    xf = np.zeros(d.n)
    xf[fixed] = d.lvar[fixed]
    shift = d.A[:, fixed] @ d.lvar[fixed]
    red = LPData(
        cvec=d.cvec[free], A=d.A[:, free],
        lcon=d.lcon - shift, ucon=d.ucon - shift,
        lvar=d.lvar[free], uvar=d.uvar[free],
        x0=None if d.x0 is None else d.x0[free],
        name=d.name, c0=d.c0 + float(d.cvec[fixed] @ d.lvar[fixed]))
    return red, xf, np.nonzero(free)[0]


def _finite(lo, hi):
    lo = np.where(np.isfinite(lo), lo, -BIG)
    hi = np.where(np.isfinite(hi), hi, BIG)
    return lo, hi


def equilibrate_rows(d: LPData) -> LPData:
    """Scale every constraint row to unit inf-norm (row equilibration —
    the standard LP-preprocessing step every industrial solver applies
    internally; HiGHS scales inside, so the f32 lane must too or it pays
    the raw row conditioning).  The primal solution and feasibility SET
    are unchanged (each row and its bounds divide by the same positive
    constant); only constraint duals change units, which BucketResult
    does not expose."""
    if d.m == 0:
        return d
    r = np.max(np.abs(d.A), axis=1)
    r = np.where(r > 0.0, r, 1.0)
    return LPData(cvec=d.cvec, A=d.A / r[:, None],
                  lcon=d.lcon / r, ucon=d.ucon / r,
                  lvar=d.lvar, uvar=d.uvar, x0=d.x0,
                  name=d.name, c0=d.c0)


def pad_lp(d: LPData, n_pad: int, m_pad: int) -> LPData:
    """Pad to (n_pad vars, m_pad rows) with neutral data; all bounds finite."""
    n, m = d.n, d.m
    A = np.zeros((m_pad, n_pad))
    A[:m, :n] = d.A
    cvec = np.zeros(n_pad)
    cvec[:n] = d.cvec
    lcon = np.full(m_pad, -1.0)
    ucon = np.full(m_pad, 1.0)
    lcon[:m], ucon[:m] = _finite(d.lcon, d.ucon)
    lvar = np.full(n_pad, -1.0)
    uvar = np.full(n_pad, 1.0)
    lvar[:n], uvar[:n] = _finite(d.lvar, d.uvar)
    x0 = np.zeros(n_pad)
    if d.x0 is not None:
        x0[:n] = d.x0
    return LPData(cvec=cvec, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar,
                  x0=x0, name=d.name, c0=d.c0)


def bucket_template(n_pad: int, m_pad: int) -> NLPSpec:
    """Parametric LP template for one shape class.

    All bounds finite (values are per-instance bvals; the [-1, 1] template
    values only fix the static canonical row pattern), data in pdata; the
    Jacobian is the instance's A, evaluated once per solve.
    """
    pdata = {"A": np.zeros((m_pad, n_pad)), "c": np.zeros(n_pad),
             "c0": np.zeros(())}
    return NLPSpec(
        f=lambda x, pd: torch.dot(pd["c"], x) + pd["c0"],
        c=lambda x, pd: pd["A"] @ x,
        jac=lambda x, pd: pd["A"],
        lcon=np.full(m_pad, -1.0), ucon=np.full(m_pad, 1.0),
        lvar=np.full(n_pad, -1.0), uvar=np.full(n_pad, 1.0),
        x0=np.zeros(n_pad), lin=tuple(range(m_pad)),
        name=f"lp_bucket_{n_pad}x{m_pad}",
        constant_jac=True, constant_hess=True, zero_hess=True, pdata=pdata)


def bucket_shapes(datas: Sequence[LPData], round_to: int = 64) -> Dict[Tuple[int, int], List[int]]:
    """Group instance indices by padded shape class."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, d in enumerate(datas):
        fixed = d.lvar == d.uvar
        n_eff = int((~fixed).sum())
        key = (_round_up(max(n_eff, 1), round_to), _round_up(max(d.m, 1), round_to))
        buckets.setdefault(key, []).append(i)
    return buckets


# (n_pad, m_pad, pars, dtype, device) -> (nlp, solver)
_SOLVER_CACHE: Dict[tuple, tuple] = {}


class BucketSolver(NamedTuple):
    """One cached bucket solver: its shape class, options, its NLP's dtype
    and its kernel's device, and the host reads the kernel has made."""

    n_pad: int
    m_pad: int
    pars: Params
    dtype: torch.dtype
    device: torch.device
    host_syncs: int


def bucket_solvers() -> List[BucketSolver]:
    """Every bucket solver `solve_bucketed` has built in this process (a
    float64 escalation pass builds its own).  A campaign's host reads are
    the growth of their `host_syncs` across it."""
    return [BucketSolver(n_pad, m_pad, pars, nlp.dtype, solver.kernel.device,
                         solver.kernel.host_syncs)
            for (n_pad, m_pad, pars, _, _), (nlp, solver)
            in _SOLVER_CACHE.items()]


def solve_bucketed(problems: Dict[str, LPData],
                   pars: Optional[Params] = None,
                   round_to: int = 64,
                   max_batch: int = 256,
                   dtype=None,
                   escalate_f64: bool = False,
                   scale_rows: bool = True,
                   device=None) -> Dict[str, BucketResult]:
    """Solve a heterogeneous dict of LPs as shape-bucketed batches on
    `device` (default: the CUDA card) in `dtype` (default float64).

    Kernels are cached per (shape class, pars, dtype, device) for the
    process lifetime, so repeat campaigns over the same shape classes build
    nothing again (the Params tree is frozen and hashable).

    `escalate_f64`: instances that end MAX_IT/MAX_DELTA/STALLED under a
    float32 solve get ONE float64 re-solve pass (as a second set of
    buckets, `term.max_it` capped at 80) on the same device, and are marked
    `escalated`."""
    pars = pars or Params()
    dtype = dtype or torch.float64
    dev = resolve_device(device)
    names = list(problems.keys())
    raw = [problems[k] for k in names]

    reduced, insts = [], []
    for name, d in zip(names, raw):
        red, xf, free = eliminate_fixed(d)
        if scale_rows:
            red = equilibrate_rows(red)
        reduced.append(red)
        insts.append(_Instance(name=name, n_true=red.n, x_fixed=xf,
                               free_idx=free, c0=red.c0))

    out: Dict[str, BucketResult] = {}
    for (n_pad, m_pad), idxs in bucket_shapes(reduced, round_to).items():
        key = (n_pad, m_pad, pars, dtype, dev)
        if key in _SOLVER_CACHE:
            nlp, solver = _SOLVER_CACHE[key]
        else:
            spec = bucket_template(n_pad, m_pad)
            nlp = canonicalize(spec, dtype=dtype, device=dev)
            solver = BatchSolver(nlp, pars)
            _SOLVER_CACHE[key] = (nlp, solver)
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo:lo + max_batch]
            padded = [pad_lp(reduced[i], n_pad, m_pad) for i in chunk]

            def stack(rows):
                return torch.as_tensor(np.stack(rows), dtype=nlp.dtype,
                                       device=dev)

            pdata = {"A": stack([p.A for p in padded]),
                     "c": stack([p.cvec for p in padded]),
                     "c0": stack([np.float64(p.c0) for p in padded])}
            bvals = {"l": stack([p.lcon for p in padded]),
                     "u": stack([p.ucon for p in padded]),
                     "lv": stack([p.lvar for p in padded]),
                     "uv": stack([p.uvar for p in padded])}
            x0s = np.stack([p.x0 for p in padded])
            st = solver.solve(x0s, bvals=bvals, pdata=pdata)

            xs = st.p.x.double().cpu().numpy()
            objs = st.cache.fval.double().cpu().numpy()
            its = st.t.cpu().numpy() - 1
            a = st.cache.a.double().cpu().numpy()
            statuses = st.status.cpu().numpy()
            # last history row per instance (final-iterate metrics)
            buf = st.hist.buf.double().cpu().numpy()    # (B, cap, NCOLS)
            cnt = st.hist.count.cpu().numpy()
            last = np.clip(cnt - 1, 0, buf.shape[1] - 1)
            rows = buf[np.arange(buf.shape[0]), last]
            for bi, i in enumerate(chunk):
                inst = insts[i]
                x_full = np.array(inst.x_fixed)
                x_full[inst.free_idx] = xs[bi, :inst.n_true]
                out[inst.name] = BucketResult(
                    status=STATUS_NAMES[int(statuses[bi])],
                    obj=float(objs[bi]),
                    x=x_full, iterations=int(its[bi]),
                    max_violation=float(max(0.0, -a[bi].min())),
                    name=inst.name,
                    dual_feas=float(rows[bi, IDX["dual_scaled"]]),
                    comp=float(rows[bi, IDX["comp"]]))

    if escalate_f64 and dtype != torch.float64:
        unresolved = sorted(name for name, r in out.items()
                            if r.status in ("MAX_IT", "MAX_DELTA", "STALLED"))
        if unresolved:
            # one float64 pass, on the same device: the f64 lane certifies
            # in well under the f32 budget (the JAX package's
            # scripts/diag_infeas.py: <= 40 outer iterations against 120),
            # so its budget is capped
            esc_pars = pars.with_overrides({
                "term.max_it": min(pars.term.max_it, ESCALATE_MAX_IT)})
            res64 = solve_bucketed({k: problems[k] for k in unresolved},
                                   esc_pars, round_to=round_to,
                                   max_batch=max_batch, dtype=torch.float64,
                                   escalate_f64=False, device=dev)
            for k, r in res64.items():
                r.escalated = True
                out[k] = r
    return out
