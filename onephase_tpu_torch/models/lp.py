"""Dense LP models: the data form and its NLPSpec, the infeasible
perturbation, and the MPS reader and writer.

Port of onephase_tpu/models/lp.py.  The spec declares a constant Jacobian
and a zero Hessian, so the Schur-dual path (ipm/dual.py) takes it.
`write_mps` and `read_mps_data` are numpy only and copied from the JAX
package unchanged (tests/test_torch_config.py pins the copies);
`read_mps` builds the torch spec.
"""

from __future__ import annotations

import copy
import gzip
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..nlp import NLPSpec, resolve_device
from .qp import Data

INF = np.inf


@dataclass
class LPData:
    """Raw dense LP: min c^T x + c0 s.t. lcon <= A x <= ucon,
    lvar <= x <= uvar (host float64 arrays)."""

    cvec: np.ndarray
    A: np.ndarray
    lcon: np.ndarray
    ucon: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    x0: Optional[np.ndarray] = None
    name: str = "lp"
    c0: float = 0.0
    # "max" records an OBJSENSE MAX source; cvec/c0 are already negated to
    # min-form, so the min-form optimum is -(the source's optimum)
    objsense: str = "min"

    @property
    def n(self):
        return self.A.shape[1]

    @property
    def m(self):
        return self.A.shape[0]

    def to_spec(self, device=None) -> NLPSpec:
        return lp_spec(self.cvec, self.A, self.lcon, self.ucon, self.lvar,
                       self.uvar, self.x0, name=self.name, c0=self.c0,
                       device=device)


def lp_spec(cvec, A, lcon, ucon, lvar=None, uvar=None, x0=None,
            name="lp", c0: float = 0.0, device=None) -> NLPSpec:
    """min c^T x + c0  s.t. lcon <= A x <= ucon, lvar <= x <= uvar.  The
    data lives on `device` (default: the CUDA card)."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    dev = resolve_device(device)
    At = Data(A, dev)
    ct = Data(np.asarray(cvec, dtype=np.float64), dev)
    return NLPSpec(
        f=lambda x: torch.dot(ct(x.dtype), x) + c0,
        c=(lambda x: At(x.dtype) @ x) if m > 0 else None,
        lcon=np.asarray(lcon, dtype=np.float64) if m > 0 else None,
        ucon=np.asarray(ucon, dtype=np.float64) if m > 0 else None,
        lvar=lvar if lvar is not None else np.full(n, -INF),
        uvar=uvar if uvar is not None else np.full(n, INF),
        x0=x0 if x0 is not None else np.zeros(n),
        lin=tuple(range(m)), name=name,
        constant_jac=True, constant_hess=True, zero_hess=True)


def perturb_infeasible(spec: NLPSpec, scale: float = 1.0) -> NLPSpec:
    """Shift the constraint ranges by -scale (reference perturb_cons,
    infeas.jl:3-33)."""
    out = copy.copy(spec)
    out.lcon = spec.lcon - scale
    out.ucon = spec.ucon - scale
    out.name = spec.name + "_infeas"
    return out


# ---------------------------------------------------------------------------
# MPS writer — emits standard (free-form) MPS so synthetic suites can be
# round-tripped through `read_mps` + the directory campaign driver exactly
# the way real Netlib archives are ingested (reference run_netlib.jl:4-66
# loads the canonical files from disk; here the disk artifact is the test).
# ---------------------------------------------------------------------------
def write_mps(d: LPData, path: str) -> None:
    """Write an LPData as free-form MPS.

    Row encoding: equalities as E; one-sided rows as L/G; two-sided
    inequality rows as L with a RANGES entry (lcon = rhs - |range|).
    Free rows (both sides infinite) are not representable as constraints
    and are rejected.  The objective constant rides as RHS on the
    objective row (read back as c0 = -rhs).
    """
    m, n = d.m, d.n
    if m and np.any(np.isinf(d.lcon) & np.isinf(d.ucon)
                    & (d.lcon < 0) & (d.ucon > 0)):
        raise ValueError("free constraint rows are not representable in MPS")

    def fmt(v):
        return f"{v:.17g}"

    lines = [f"NAME {d.name}", "ROWS", " N  OBJ"]
    rtypes = []
    for i in range(m):
        lf, uf = np.isfinite(d.lcon[i]), np.isfinite(d.ucon[i])
        if lf and uf and d.lcon[i] == d.ucon[i]:
            t = "E"
        elif uf:
            t = "L"      # two-sided rows: L + RANGES
        else:
            t = "G"
        rtypes.append(t)
        lines.append(f" {t}  R{i}")

    lines.append("COLUMNS")
    for j in range(n):
        if d.cvec[j] != 0.0:
            lines.append(f"    C{j}  OBJ  {fmt(d.cvec[j])}")
        for i in np.nonzero(d.A[:, j])[0]:
            lines.append(f"    C{j}  R{i}  {fmt(d.A[i, j])}")

    lines.append("RHS")
    if d.c0:
        lines.append(f"    RHS  OBJ  {fmt(-d.c0)}")
    for i, t in enumerate(rtypes):
        b = d.ucon[i] if t in ("L", "E") else d.lcon[i]
        if b != 0.0:
            lines.append(f"    RHS  R{i}  {fmt(b)}")

    rng = [(i, d.ucon[i] - d.lcon[i]) for i, t in enumerate(rtypes)
           if t == "L" and np.isfinite(d.lcon[i])]
    if rng:
        lines.append("RANGES")
        for i, r in rng:
            lines.append(f"    RNG  R{i}  {fmt(r)}")

    lines.append("BOUNDS")
    for j in range(n):
        lv, uv = d.lvar[j], d.uvar[j]
        lf, uf = np.isfinite(lv), np.isfinite(uv)
        if lf and uf and lv == uv:
            lines.append(f" FX BND  C{j}  {fmt(lv)}")
            continue
        if not lf and not uf:
            lines.append(f" FR BND  C{j}")
            continue
        if not lf:
            lines.append(f" MI BND  C{j}")
        elif lv != 0.0:
            lines.append(f" LO BND  C{j}  {fmt(lv)}")
        if uf:
            lines.append(f" UP BND  C{j}  {fmt(uv)}")

    lines.append("ENDATA")
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# MPS reader (fixed + free format tolerant) — enough for the Netlib sets.
# ---------------------------------------------------------------------------
def read_mps(path: str, name: Optional[str] = None, device=None) -> NLPSpec:
    """The NLPSpec of an MPS file, its data on `device` (default: the CUDA
    card)."""
    return read_mps_data(path, name).to_spec(device=device)


def read_mps_data(path: str, name: Optional[str] = None) -> LPData:
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rt") as fh:
        lines = fh.readlines()

    section = None
    row_type: Dict[str, str] = {}
    row_order = []
    obj_row = None
    cols: Dict[str, Dict[str, float]] = {}
    col_order = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    lo: Dict[str, float] = {}
    up: Dict[str, float] = {}
    free_vars = set()
    prob_name = name or "mps"
    in_integer = False
    objsense = "min"

    def _is_num(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False

    for raw in lines:
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if raw[0] not in " \t":
            tok = raw.split()
            section = tok[0].upper()
            if section == "NAME" and len(tok) > 1 and name is None:
                prob_name = tok[1]
            # OBJSENSE may carry the sense inline ("OBJSENSE MAX") or on
            # the following indented line (both appear in real archives).
            if section == "OBJSENSE" and len(tok) > 1:
                objsense = ("max" if tok[1].upper().startswith("MAX")
                            else "min")
            if section == "ENDATA":
                break
            continue
        tok = raw.split()
        if section == "OBJSENSE":
            objsense = "max" if tok[0].upper().startswith("MAX") else "min"
        elif section == "ROWS":
            rt, rn = tok[0].upper(), tok[1]
            if rt == "N":
                if obj_row is None:
                    obj_row = rn
            else:
                row_type[rn] = rt
                row_order.append(rn)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                in_integer = "INTORG" in raw.upper()
                continue
            cn = tok[0]
            if cn not in cols:
                cols[cn] = {}
                col_order.append(cn)
            for i in range(1, len(tok) - 1, 2):
                cols[cn][tok[i]] = float(tok[i + 1])
        elif section in ("RHS", "RANGES"):
            # The RHS/RANGES *set name* (tok[0]) is optional in real files:
            # with it the line has an odd token count (name + pairs),
            # without it an even count (pairs only).
            start = 1 if len(tok) % 2 == 1 else 0
            dst = rhs if section == "RHS" else ranges
            for i in range(start, len(tok) - 1, 2):
                dst[tok[i]] = float(tok[i + 1])
        elif section == "BOUNDS":
            bt = tok[0].upper()
            # Bound-set name (tok[1]) is also optional: detect by whether
            # the value slot parses as a number (value-typed bounds) or by
            # token count (value-free FR/MI/PL/BV).
            if bt in ("FR", "MI", "PL", "BV"):
                cn = tok[1] if len(tok) == 2 else tok[2]
                val = 0.0
            elif len(tok) >= 4:
                cn, val = tok[2], float(tok[3])
            elif len(tok) == 3 and _is_num(tok[2]):
                cn, val = tok[1], float(tok[2])
            else:  # "UP BND C1" with the value omitted -> 0.0
                cn, val = tok[2], 0.0
            if bt in ("LO", "LI"):
                lo[cn] = val
            elif bt in ("UP", "UI"):
                up[cn] = val
                if val < 0 and cn not in lo:
                    lo[cn] = -INF
            elif bt == "FX":
                lo[cn] = val
                up[cn] = val
            elif bt == "FR":
                free_vars.add(cn)
            elif bt == "MI":
                lo[cn] = -INF
            elif bt == "PL":
                up[cn] = INF
            elif bt == "BV":
                lo[cn], up[cn] = 0.0, 1.0

    n = len(col_order)
    m = len(row_order)
    ridx = {r: i for i, r in enumerate(row_order)}
    A = np.zeros((m, n))
    cvec = np.zeros(n)
    for j, cn in enumerate(col_order):
        for rn, v in cols[cn].items():
            if rn == obj_row:
                cvec[j] = v
            elif rn in ridx:
                A[ridx[rn], j] = v

    lcon = np.full(m, -INF)
    ucon = np.full(m, INF)
    for rn, i in ridx.items():
        b = rhs.get(rn, 0.0)
        t = row_type[rn]
        if t == "E":
            lcon[i] = ucon[i] = b
        elif t == "L":
            ucon[i] = b
        elif t == "G":
            lcon[i] = b
        if rn in ranges:
            r = ranges[rn]
            if t == "E":
                if r >= 0:
                    ucon[i] = b + r
                else:
                    lcon[i] = b + r
            elif t == "L":
                lcon[i] = b - abs(r)
            elif t == "G":
                ucon[i] = b + abs(r)

    lvar = np.zeros(n)
    uvar = np.full(n, INF)
    for j, cn in enumerate(col_order):
        if cn in free_vars:
            lvar[j], uvar[j] = -INF, INF
        else:
            if cn in lo:
                lvar[j] = lo[cn]
            if cn in up:
                uvar[j] = up[cn]

    c0 = -rhs.get(obj_row, 0.0)  # objective-row RHS is a constant offset
    if objsense == "max":  # solve min-form; optimum = -(file optimum)
        cvec, c0 = -cvec, -c0
    return LPData(cvec=cvec, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar,
                  name=prob_name, c0=c0, objsense=objsense)
