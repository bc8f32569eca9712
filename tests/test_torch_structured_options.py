"""The precision knobs and the Mehrotra init on the structured kernels: every
non-default value of the options the dense Schur path reads
(`kkt.factor_precision`, `fallback_form_f32`, `hi_matvec_f32pair`,
`precond_f32`, `q_form_dtype`, `residual_precision`, `init.init_style`)
on ChainKernel, BandedKernel (assembled) and ScenarioKernel, held to what
the JAX package's kernel does with it on the CPU in float64, `xla` lane.

Where the JAX kernel runs the option, the port runs it: equal status,
outer iterations and factorizations, x to 1e-8 and the mu trace to 1e-8
relative.  Where it raises, the port raises the same exception type: the
banded kernel's ValueError for any factor_precision but "same"; on the
chain and scenario kernels factor_precision="f32", whose float32 stale
factor the JAX delta search cannot select against the float64 block
factor (a TypeError in its `lax.cond`; the port raises it at
construction).  Problems: chain_ocp(K=6, nx=4, mc=2), the same as a flat
NLP for the banded kernel, and two_stage_qp() (K=4).
"""

import numpy as np
import pytest
import torch

from onephase_tpu import one_phase_solve as jsolve
from onephase_tpu.config import Params as JParams
from onephase_tpu.models.examples import chain_ocp as jchain
from onephase_tpu.models.examples import two_stage_qp as jts
from onephase_tpu.nlp import canonicalize as jcanon
from onephase_tpu.parallel.banded import BandedKernel as JBanded
from onephase_tpu.parallel.chain import ChainKernel as JChain
from onephase_tpu.parallel.scenario import ScenarioKernel as JScen
from onephase_tpu_torch import one_phase_solve as tsolve
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.models.examples import chain_ocp as tchain
from onephase_tpu_torch.models.examples import two_stage_qp as tts
from onephase_tpu_torch.nlp import canonicalize as tcanon
from onephase_tpu_torch.parallel.banded import BandedKernel as TBanded
from onephase_tpu_torch.parallel.chain import ChainKernel as TChain
from onephase_tpu_torch.parallel.scenario import ScenarioKernel as TScen
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
OPTS = {"output_level": 0, "term.max_it": 100, "chunk_size": 100,
        "kkt.linear_solver_type": "xla"}
CHAIN = dict(K=6, nx=4, mc=2)
# every non-default value of the dense-path options
KNOBS = {
    "factor_f32": {"kkt.factor_precision": "f32"},
    "factor_f32_fallback": {"kkt.factor_precision": "f32_fallback"},
    "fallback_form_f32": {"kkt.factor_precision": "f32_fallback",
                          "kkt.fallback_form_f32": True},
    "form_f32_alone": {"kkt.fallback_form_f32": True},
    "pair_refine": {"kkt.hi_matvec_f32pair": "refine"},
    "pair_all": {"kkt.hi_matvec_f32pair": "all"},
    "precond_f32": {"kkt.precond_f32": True},
    "q_bf16": {"kkt.q_form_dtype": "bf16"},
    "residual_f64": {"kkt.residual_precision": "f64"},
    "mehrotra": {"init.init_style": "mehrotra"},
}
# the JAX kernels' outcome where they raise (else they run)
RAISES = {("chain", "factor_f32"): TypeError,
          ("scenario", "factor_f32"): TypeError,
          ("banded", "factor_f32"): ValueError,
          ("banded", "factor_f32_fallback"): ValueError,
          ("banded", "fallback_form_f32"): ValueError}


def _jax_run(kernel, pars):
    if kernel == "chain":
        k = JChain(jchain(**CHAIN), pars)
    elif kernel == "banded":
        k = JBanded(jcanon(jchain(**CHAIN).to_nlpspec()), pars)
    else:
        k = JScen(jts(), pars)
    return jsolve(None, pars, kernel=k)


def _port_run(kernel, pars):
    if kernel == "chain":
        k = TChain(tchain(**CHAIN, device="cpu"), pars, device=CPU)
    elif kernel == "banded":
        k = TBanded(tcanon(tchain(**CHAIN, device="cpu").to_nlpspec(),
                           device="cpu"), pars, device=CPU)
    else:
        k = TScen(tts(device="cpu"), pars, device=CPU)
    return tsolve(None, pars, kernel=k)


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("kernel", ["chain", "banded", "scenario"])
def test_structured_kernel_takes_option_like_jax(kernel, knob):
    over = dict(OPTS, **KNOBS[knob])
    jpars = JParams().with_overrides(over)
    tpars = TParams().with_overrides(over)
    err = RAISES.get((kernel, knob))
    if err is not None:
        with pytest.raises(err):
            _jax_run(kernel, jpars)
        with pytest.raises(err):
            _port_run(kernel, tpars)
        return
    rj = _jax_run(kernel, jpars)
    rt = _port_run(kernel, tpars)
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert rt.status == "Optimal"
    assert int(rt.state.cum_fac[0]) == int(rj.state.cum_fac)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    assert mu_t.shape == mu_j.shape
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=0)


@pytest.mark.parametrize("kernel", ["chain", "scenario"])
def test_precond_f32_on_the_pallas_lane(kernel):
    """`kkt.precond_f32` is read on the pallas lane only: the structured
    factor stays in the solve dtype, and the delta search casts the
    carried block factor leaf by leaf (the JAX package's tree_map).  Held
    to the JAX kernel on its pallas lane in interpret mode (chain) or its
    xla lane (scenario: ROADMAP R8)."""
    import onephase_tpu.ops as jops
    over = dict(OPTS, **KNOBS["precond_f32"])
    jlane = "pallas" if kernel == "chain" else "xla"
    jops.INTERPRET = jlane == "pallas"
    try:
        rj = _jax_run(kernel, JParams().with_overrides(
            dict(over, **{"kkt.linear_solver_type": jlane})))
    finally:
        jops.INTERPRET = False
    rt = _port_run(kernel, TParams().with_overrides(
        dict(over, **{"kkt.linear_solver_type": "pallas"})))
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert int(rt.state.cum_fac[0]) == int(rj.state.cum_fac)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
    assert all(t.dtype == torch.float64 for t in rt.state.fact.L)
