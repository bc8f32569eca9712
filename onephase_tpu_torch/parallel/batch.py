"""Batched solver instances.

Port of onephase_tpu/parallel/batch.py.  A batch of same-structure
instances is one batch-first state; per-instance termination is masked
(an instance that leaves RUNNING is frozen while the others go on), so a
batch runs until every instance has terminated or the chunk bound is hit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..ipm.dual import make_kernel
from ..ipm.state import MAX_TIME, RUNNING, STALLED, STATUS_NAMES, State
from ..nlp import CanonNLP


class BatchSolver:
    """Same-structure batch solver (multistart / perturbed bounds)."""

    def __init__(self, nlp: CanonNLP, pars: Optional[Params] = None):
        pars = pars or Params()
        # batched-solver variants of history_capacity / max_step_attempts
        if pars.history_capacity == 0 and pars.batch_history_capacity > 0:
            pars = pars.with_overrides(
                {"history_capacity": pars.batch_history_capacity})
        if pars.batch_max_step_attempts > 0:
            pars = pars.with_overrides(
                {"max_step_attempts": pars.batch_max_step_attempts})
        self.kernel = make_kernel(nlp, pars)
        self.pars = pars

    def init(self, x0s, bvals=None, pdata=None) -> State:
        """x0s: (B, n) starting points -> batched State.

        `bvals` optionally gives per-instance bound values (dict of (B, k)
        tensors): instances may differ in bound data and share one kernel.
        `pdata` optionally gives per-instance parametric problem data
        (NLPSpec.pdata; dict of (B, ...) arrays or tensors, cast to the
        kernel's dtype and device): per-instance constraint matrices and
        objective coefficients under one kernel.  With `pdata` and no
        `bvals` every instance takes the default bound values."""
        k = self.kernel
        x0s = torch.as_tensor(np.asarray(x0s), dtype=k.dtype, device=k.device)
        if pdata is not None:
            pdata = k.nlp.pdata_to(pdata)
        return k.initial_state_from(x0s, bvals, pdata)

    def run_chunk(self, st: State) -> State:
        return self.kernel.run_chunk(st)

    def solve(self, x0s, bvals=None, pdata=None,
              max_chunks: int = 10_000) -> State:
        """Run until every instance terminates, `max_chunks` chunks, or the
        wall-clock limit `pars.term.max_time` (still-running instances are
        marked MAX_TIME).

        Between chunks the termination criteria are re-measured in float64
        (`recheck_f64`)."""
        import time as _time
        t0 = _time.time()
        st = self.init(x0s, bvals, pdata)
        for _ in range(max_chunks):
            if self.num_running(st) == 0:
                break
            if self._agree(_time.time() - t0 > self.pars.term.max_time):
                st = st._replace(status=torch.where(
                    st.status == RUNNING, torch.full_like(st.status, MAX_TIME),
                    st.status))
                break
            st = self.recheck_f64(self.run_chunk(st))
        return st

    def num_running(self, st: State) -> int:
        """The number of instances still RUNNING (one host read)."""
        return int((st.status == RUNNING).sum())

    def _agree(self, flag: bool) -> bool:
        """A loop decision; the sharded solver takes it on every rank."""
        return flag

    def recheck_f64(self, st: State) -> State:
        """Re-measure the termination criteria of RUNNING/STALLED instances
        of a non-float64 solve with float64 oracles
        (`term.batch_f64_recheck`, batch.py:92-115 of the JAX package);
        skipped under `kkt.residual_precision="f64"`, whose in-loop test
        already measures in float64.
        The in-loop measurement only gives false negatives (rounding noise
        sits on top of the true residuals), so this can only release
        instances that the noise floor holds back."""
        if (self.kernel.dtype == torch.float64
                or self.pars.kkt.residual_precision == "f64"
                or not self.pars.term.batch_f64_recheck):
            return st
        rc_mask = (st.status == RUNNING) | (st.status == STALLED)
        if not bool(rc_mask.any()):
            return st
        codes = self.kernel.terminate_f64(st.p, st.cache, st.bvals,
                                          st.pdata)
        return st._replace(status=torch.where(
            rc_mask & (codes != RUNNING), codes, st.status))

    def statuses(self, st: State):
        return [STATUS_NAMES[int(s)] for s in st.status.cpu().numpy()]
