"""The port's mu-scale autotuning sweep (autotune.py) against the JAX
package's: tests/test_autotune.py's cases, sequential and batched, on the
CPU in float64, with the same (success, best iterations, best scale)."""

import pytest

from onephase_tpu.autotune import autotune as jautotune
from onephase_tpu.config import Params as JParams
from onephase_tpu.models import zoo as jzoo
from onephase_tpu_torch.autotune import autotune as tautotune
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.models import zoo as tzoo
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = {"term!max_it": 81, "a_norm_penalty": 1e-4, "output_level": 0}


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("name", ["circle_nc1"])
def test_autotune_matches_jax(name, parallel):
    rj = jautotune(getattr(jzoo, name)(), JParams().with_overrides(BASE),
                   exponents=range(-1, 2), parallel=parallel)
    rt = tautotune(getattr(tzoo, name)(), TParams().with_overrides(BASE),
                   exponents=range(-1, 2), parallel=parallel, device="cpu")
    assert rt == rj
    ok, best_it, best_scale = rt
    assert ok and best_it > 0 and best_scale > 0


def test_batched_equals_sequential_choice():
    """The batched sweep picks among the same candidates: its best scale
    certifies, and its iteration count is the sequential solve's at that
    scale."""
    from onephase_tpu_torch import canonicalize, one_phase_solve
    pars = TParams().with_overrides(BASE)
    ok, best_it, best_scale = tautotune(tzoo.circle_nc1(), pars,
                                        exponents=range(-2, 3),
                                        parallel=True, device="cpu")
    r = one_phase_solve(canonicalize(tzoo.circle_nc1(), device="cpu"),
                        pars.with_overrides({"init.mu_scale": best_scale}))
    assert ok and r.status == "Optimal" and r.iterations == best_it
