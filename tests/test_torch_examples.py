"""The port's example families (models/examples.py) and ECON tax models
(models/tax.py) against the JAX package's, on the CPU in float64.

Every model function makes the JAX package's problem from the same numpy draws:
bounds, x0 and the data arrays equal bit for bit, f(x0) and c(x0) to 1e-14
relative (the two libraries' summation orders; the bits agree on all but
`chain`).  At small sizes each dense solve ends with the JAX package's
status and outer iterations, the argmin to 1e-6 of max(1, |x|); chain(10),
whose trajectory the JAX package's own lanes do not agree on (ROADMAP R5),
is held to status and argmin and step by step (1e-8: its endgame's dual
least-squares step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onephase_tpu.models import examples as jex
from onephase_tpu.models import tax as jtax
from onephase_tpu_torch.models import examples as tex
from onephase_tpu_torch.models import tax as ttax
from test_torch_twins import (check_carried_steps, check_solve_parity,
                              jax_solve, port_solve)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# name -> (JAX module, port module, function, args); sizes cut to seconds
FAMILIES = {
    "polygon8": (jex, tex, "largest_small_polygon", (8,)),
    "electron6": (jex, tex, "electron", (6,)),
    "maxcut8x3": (jex, tex, "max_cut", (8, 3)),
    "kissing5d3": (jex, tex, "kissing", (5, 3)),
    "chain6": (jex, tex, "chain", (6,)),
    "econ5": (jtax, ttax, "tax1d", (5,)),
}
OPTS = {"output_level": 0, "term.max_it": 200, "chunk_size": 200}
BOUNDS = ("lcon", "ucon", "lvar", "uvar", "x0")


def _pair(name):
    jmod, tmod, fn, args = FAMILIES[name]
    return getattr(jmod, fn)(*args), getattr(tmod, fn)(*args, device="cpu")


def _close(got, want, rtol=1e-14):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


def _same_nlp(jspec, tspec):
    for k in BOUNDS:
        np.testing.assert_array_equal(getattr(tspec, k),
                                      np.asarray(getattr(jspec, k)), k)
    x0 = np.asarray(jspec.x0)
    _close(tspec.f(torch.as_tensor(x0)).numpy(), jspec.f(jnp.asarray(x0)))
    _close(tspec.c(torch.as_tensor(x0)).numpy(), jspec.c(jnp.asarray(x0)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_builds_the_jax_problem(name):
    _same_nlp(*_pair(name))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_solves_like_jax(name):
    jspec, tspec = _pair(name)
    rj = jax_solve(jspec, OPTS)
    rt = port_solve(tspec, OPTS, "xla")
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert rt.status == "Optimal"
    _close(rt.x, rj.x, 1e-6)


def test_chain_lane_split_held_step_by_step():
    """chain(10) is Rosenbrock's valley: the JAX package's xla and invchol
    lanes end in 53 and 49 outer iterations (the port's in 45 and 51), as
    rosenbrook3/4 do (ROADMAP R5).  Status and argmin are held, and every
    outer iteration from the JAX package's own state, to 1e-8: once |y|
    falls below 1e-5 the dual least-squares step alpha_D divides residuals
    that are differences of O(100) gradient terms, and the two packages'
    alpha_D from the same state differ by up to 1.1e-9 (x to 1e-16, the
    directions to 1e-15)."""
    jspec, tspec = jex.chain(10), tex.chain(10, device="cpu")
    rj = jax_solve(jspec, OPTS)
    check_solve_parity(port_solve(tspec, OPTS, "xla"), rj, iterations=False)
    assert check_carried_steps(None, OPTS, specs=(jspec, tspec),
                               tol=1e-8) == rj.iterations


@pytest.mark.parametrize("build, kw", [
    ("two_stage_qp", dict(K=5, nz=3, nx=4, mc=2, seed=3)),
    ("tax_grouped", dict(G=10, na_g=4, wage_spread="additive")),
    ("tax_grouped", dict(G=10, na_g=4, wage_spread="banded")),
])
def test_two_stage_builds_the_jax_problem(build, kw):
    """The scenario data, the block sizes and the flat lowering equal the
    JAX package's (banded: the wage band of g % 8 from group 8 on)."""
    jmod, tmod = (jex, tex) if build == "two_stage_qp" else (jtax, ttax)
    js = getattr(jmod, build)(**kw)
    ts = getattr(tmod, build)(**kw, device="cpu")
    for k in ("K", "nz", "nx", "mc", "name"):
        assert getattr(ts, k) == getattr(js, k), k
    for k in ("lcon", "ucon", "lz", "uz", "lx", "ux", "z0", "x0"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k), k)
    assert sorted(ts.data) == sorted(js.data)
    for k, v in js.data.items():
        np.testing.assert_array_equal(ts.data[k](torch.float64).numpy(),
                                      np.asarray(v), k)
        np.testing.assert_array_equal(ts.data[k](torch.float32).numpy(),
                                      np.asarray(v).astype(np.float32), k)
    _same_nlp(js.to_nlpspec(), ts.to_nlpspec())


def test_unknown_wage_spread_raises():
    """The JAX package falls through to "additive" on any other value
    (ROADMAP R4); the port refuses it."""
    for bad in ("banded ", "Banded", "multiplicative"):
        with pytest.raises(ValueError, match="wage_spread"):
            ttax.tax_grouped(G=2, na_g=3, wage_spread=bad, device="cpu")
