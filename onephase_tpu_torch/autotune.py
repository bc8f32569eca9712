"""mu-scale autotuning sweep.

Port of onephase_tpu/autotune.py (reference: src/utils/autotune.jl:1-30):
sweep `init.mu_scale` over 10^-2..10^5 and keep the scale with the fewest
iterations to :Optimal.  (The reference version is dead code; this is the
working equivalent.)

The sweep members are independent solves of the same problem, so with
`parallel=True` they run as one batch on the port's batched kernel: one
initial state per candidate with its mu scaled and its duals re-centred,
then the batch's chunks until every member has terminated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Params
from .ipm.state import OPTIMAL, RUNNING
from .nlp import NLPSpec, canonicalize
from .solver import one_phase_solve


def autotune(problem, pars: Optional[Params] = None,
             exponents=range(-2, 6), parallel: bool = False,
             device=None) -> Tuple[bool, int, float]:
    """Returns (success, best_iterations, best_mu_scale).  An NLPSpec is
    canonicalized in float64 on `device` (default: the CUDA card); a
    CanonNLP keeps its own."""
    pars = pars or Params()
    best_it = np.inf
    best_scale = 0.0
    nlp = (problem if not isinstance(problem, NLPSpec)
           else canonicalize(problem, device=device))

    if parallel:
        return _autotune_batched(nlp, pars, exponents)

    for e in exponents:
        scale = 10.0 ** e
        p = pars.with_overrides({"init.mu_scale": scale})
        if pars.output_level >= 1:
            print(f"--------  MU_SCALE = {scale} ----------")
        r = one_phase_solve(nlp, p)
        if r.status_code == OPTIMAL and r.iterations < best_it - 1:
            best_it = r.iterations
            best_scale = scale
    return best_scale > 0.0, int(best_it) if np.isfinite(best_it) else -1, best_scale


def _autotune_batched(nlp, pars, exponents):
    """All mu_scale candidates as one batch (shared structure)."""
    from .ipm.core import OnePhaseKernel

    # mu_scale enters only through the initial state's mu; one kernel, mu
    # scaled after init (correct_guess3: mu *= mu_scale)
    p = pars.with_overrides({"output_level": 0, "history_capacity": 2})
    kernel = OnePhaseKernel(nlp, p)
    scales = torch.as_tensor([10.0 ** e for e in exponents],
                             dtype=kernel.dtype, device=kernel.device)
    B = scales.shape[0]
    x0 = torch.as_tensor(nlp.x0, dtype=kernel.dtype, device=kernel.device)
    st = kernel.initial_state_from(x0.expand(B, -1).contiguous())
    pt = st.p._replace(mu=st.p.mu * scales)
    # re-center duals for the scaled mu (change_mu!, guess-vars.jl:179-189)
    cf = p.ls.comp_feas * 2.0
    y_c = pt.mu[:, None] / pt.s
    y = torch.minimum(y_c / cf, torch.maximum(pt.y, cf * y_c))
    pt = pt._replace(y=y)
    st = st._replace(p=pt, cache=st.cache._replace(
        jt_y=kernel.nlp.jtprod(pt.x, y, st.pdata)))
    for _ in range(1 + p.term.max_it // p.chunk_size):
        if not bool((st.status == RUNNING).any()):
            break
        st = kernel.run_chunk(st)
    its = st.t.cpu().numpy() - 1
    ok = st.status.cpu().numpy() == OPTIMAL
    if not ok.any():
        return False, -1, 0.0
    best_idx = int(np.argmin(np.where(ok, its, np.inf)))
    return True, int(its[best_idx]), float(scales[best_idx])
