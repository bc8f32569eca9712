"""Modeling front-end: JuMP/MOI-style incremental model builder.

Reference: src/JuMPinterface.jl — `OnePhaseSolver <: MOI.AbstractOptimizer`
with variable bounds/fix constraints (:254-399), linear + quadratic
le/ge/eq/interval constraint stores (:401-448), NLP block (:721-724),
options via `"a!b"` raw attributes (:570-586), status mapping (:555-568),
and result getters (:763-828).

The Python analogue builds an `NLPSpec` (constraint order: linear,
quadratic, nonlinear — matching the reference's eval order,
Class_cutest.jl:399-404) and solves it with `one_phase_solve`.  Port of
onephase_tpu/model.py: the constraint body is built from torch ops, its
data on the device the model is solved on (`optimize(device=)`, default:
the CUDA card), and solved in float64.  A nonlinear constraint or a
callable objective is written for one instance (1-D x) in torch ops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import Params
from .models.qp import Data
from .nlp import NLPSpec, canonicalize, resolve_device
from .solver import Result, one_phase_solve

INF = math.inf

# MOI-style termination statuses (status_One_Phase_To_JuMP,
# JuMPinterface.jl:555-568)
STATUS_TO_MOI = {
    "Optimal": "LOCALLY_SOLVED",
    "primal_infeasible": "INFEASIBLE",
    "dual_infeasible": "DUAL_INFEASIBLE",
    "MAX_IT": "ITERATION_LIMIT",
    "MAX_TIME": "TIME_LIMIT",
    "MAX_DELTA": "NUMERICAL_ERROR",
    "NaN_ERR": "NUMERICAL_ERROR",
    "RUNNING": "OPTIMIZE_NOT_CALLED",
    "STALLED": "SLOW_PROGRESS",
}


@dataclass
class Variable:
    index: int
    name: str = ""

    # allow use as a dict key in linear expressions
    def __hash__(self):
        return hash(("var", self.index))


@dataclass
class _VarInfo:
    """reference VariableInfo (JuMPinterface.jl:38-48)."""

    lower: float = -INF
    upper: float = INF
    start: Optional[float] = None
    is_fixed: bool = False
    name: str = ""


LinExpr = Dict[Variable, float]


@dataclass
class _LinCon:
    coeffs: List[Tuple[int, float]]
    lb: float
    ub: float


@dataclass
class _QuadCon:
    quad: List[Tuple[int, int, float]]
    lin: List[Tuple[int, float]]
    lb: float
    ub: float


class Model:
    """Incremental model: variables, linear/quadratic/nonlinear constraints,
    objective; `optimize()` canonicalizes and solves."""

    def __init__(self, options: Optional[Dict[str, Any]] = None):
        self.vars: List[_VarInfo] = []
        self.lin_cons: List[_LinCon] = []
        self.quad_cons: List[_QuadCon] = []
        self.nl_cons: List[Tuple[Callable, float, float]] = []
        self._obj_fn: Optional[Callable] = None
        self._obj_sense = 1.0   # +1 min, -1 max
        self.options: Dict[str, Any] = dict(options or {})
        self.result: Optional[Result] = None

    # ---------------------------------------------------------------- build
    def add_variable(self, lb: float = -INF, ub: float = INF,
                     start: Optional[float] = None, name: str = "") -> Variable:
        self.vars.append(_VarInfo(lower=lb, upper=ub, start=start,
                                  is_fixed=(lb == ub), name=name))
        return Variable(len(self.vars) - 1, name)

    def add_variables(self, n: int, lb: float = -INF, ub: float = INF,
                      start: Optional[float] = None) -> List[Variable]:
        return [self.add_variable(lb, ub, start) for _ in range(n)]

    def fix_variable(self, v: Variable, value: float):
        info = self.vars[v.index]
        info.lower = info.upper = value
        info.is_fixed = True

    def set_lower_bound(self, v: Variable, lb: float):
        self.vars[v.index].lower = lb

    def set_upper_bound(self, v: Variable, ub: float):
        self.vars[v.index].upper = ub

    def add_linear_constraint(self, expr: LinExpr, lb: float = -INF,
                              ub: float = INF):
        self.lin_cons.append(_LinCon(
            [(v.index, c) for v, c in expr.items()], lb, ub))

    def add_quadratic_constraint(self, quad: Sequence[Tuple[Variable, Variable, float]],
                                 lin: Optional[LinExpr] = None,
                                 lb: float = -INF, ub: float = INF):
        self.quad_cons.append(_QuadCon(
            [(a.index, b.index, c) for a, b, c in quad],
            [(v.index, c) for v, c in (lin or {}).items()], lb, ub))

    def add_nonlinear_constraint(self, fn: Callable, lb: float = -INF,
                                 ub: float = INF):
        """fn maps the full variable vector -> scalar."""
        self.nl_cons.append((fn, lb, ub))

    def set_objective(self, fn_or_expr: Union[Callable, LinExpr],
                      sense: str = "min"):
        self._obj_sense = 1.0 if sense.lower().startswith("min") else -1.0
        if callable(fn_or_expr):
            self._obj_fn = fn_or_expr
        else:
            coeffs = [(v.index, c) for v, c in fn_or_expr.items()]

            def lin_obj(x):
                return sum(c * x[i] for i, c in coeffs)

            self._obj_fn = lin_obj

    minimize = lambda self, fn: self.set_objective(fn, "min")
    maximize = lambda self, fn: self.set_objective(fn, "max")

    def set_option(self, name: str, value: Any):
        """Raw attribute with `a!b` path syntax (JuMPinterface.jl:570-586)."""
        self.options[name] = value

    # ------------------------------------------------------------- assemble
    def build_spec(self, device=None) -> NLPSpec:
        """The model's NLPSpec, its data on `device` (default: the CUDA
        card)."""
        dev = resolve_device(device)
        nv = len(self.vars)
        lvar = np.array([v.lower for v in self.vars])
        uvar = np.array([v.upper for v in self.vars])
        x0 = np.array([v.start if v.start is not None else 0.0
                       for v in self.vars])

        lin_data = [(torch.as_tensor([i for i, _ in c.coeffs],
                                     dtype=torch.long, device=dev),
                     Data(np.array([co for _, co in c.coeffs],
                                   dtype=np.float64), dev))
                    for c in self.lin_cons]
        lcon = ([c.lb for c in self.lin_cons]
                + [c.lb for c in self.quad_cons]
                + [lb for _, lb, _ in self.nl_cons])
        ucon = ([c.ub for c in self.lin_cons]
                + [c.ub for c in self.quad_cons]
                + [ub for _, _, ub in self.nl_cons])
        quad_cons = self.quad_cons
        nl_cons = self.nl_cons
        sense = self._obj_sense
        obj_fn = self._obj_fn
        if obj_fn is None:
            obj_fn = lambda x: 0.0 * x[0]  # feasibility problem

        def c_all(x):
            vals = []
            for idx, co in lin_data:
                vals.append(torch.dot(co(x.dtype), x[idx]))
            for q in quad_cons:
                v = 0.0
                for i, j, co in q.quad:
                    v = v + co * x[i] * x[j]
                for i, co in q.lin:
                    v = v + co * x[i]
                vals.append(v)
            for fn, _, _ in nl_cons:
                vals.append(fn(x))
            return (torch.stack(vals) if vals
                    else torch.zeros(0, dtype=x.dtype, device=x.device))

        m = len(lcon)
        return NLPSpec(
            f=lambda x: sense * obj_fn(x),
            c=c_all if m > 0 else None,
            lcon=np.asarray(lcon), ucon=np.asarray(ucon),
            lvar=lvar, uvar=uvar, x0=x0,
            lin=tuple(range(len(self.lin_cons))),
            name="model")

    # --------------------------------------------------------------- solve
    def optimize(self, pars: Optional[Params] = None, device=None) -> Result:
        """Canonicalize in float64 on `device` (default: the CUDA card) and
        solve."""
        dev = resolve_device(device)
        nlp = canonicalize(self.build_spec(dev), device=dev)
        self.result = one_phase_solve(nlp, pars=pars, options=self.options)
        return self.result

    # --------------------------------------------------------------- query
    @property
    def termination_status(self) -> str:
        if self.result is None:
            return STATUS_TO_MOI["RUNNING"]
        return STATUS_TO_MOI.get(self.result.status, "OTHER_ERROR")

    @property
    def raw_status(self) -> str:
        return self.result.status if self.result else "RUNNING"

    @property
    def objective_value(self) -> float:
        return self._obj_sense * self.result.obj

    def value(self, v: Variable) -> float:
        return float(self.result.x[v.index])

    def dual(self, constraint_index: int) -> float:
        return float(self.result.constr_duals[constraint_index])

    def reduced_cost(self, v: Variable) -> float:
        return float(self.result.reduced_costs[v.index])
