"""The port's batch-first torch.func oracles against the JAX package's
oracles on the same problems and points, float64, to 1e-12 (relative to
the larger of 1 and the value's magnitude)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from test_torch_twins import fixed_var_pair, qp_pair, zoo_pair

TOL = 1e-12
PROBLEMS = ["rosenbrook2", "toy_lp1", "toy_lp_inf1", "circle1", "quad_opt",
            "lp_unbd", "unbd_feas", "hs071", "fixed_var", "qp"]


def _pair(name):
    if name == "fixed_var":
        return fixed_var_pair()
    if name == "qp":
        return qp_pair(32, 16)
    return zoo_pair(name)


def _close(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("name", PROBLEMS)
def test_oracles_match_jax(name):
    jspec, tspec = _pair(name)
    J = jnlp.canonicalize(jspec, dtype=jnp.float64)
    T = tnlp.canonicalize(tspec, dtype=torch.float64, device="cpu")
    assert (T.n, T.m, T.m_orig, T.m_cons) == (J.n, J.m, J.m_orig, J.m_cons)
    rng = np.random.default_rng(7)
    B = 2
    X = rng.uniform(0.5, 1.5, size=(B, J.n))
    Y = rng.uniform(0.1, 2.0, size=(B, J.m))
    V = rng.normal(size=(B, J.n))
    mu = np.array([0.3, 1e-3])
    xt, yt, vt = (torch.as_tensor(a) for a in (X, Y, V))

    out = {
        "f": T.f(xt), "c": T.c(xt), "a_of": T.a_of(xt),
        "grad_f": T.grad_f(xt), "jac_orig": T.jac_orig(xt),
        "lag_hess": T.lag_hess(xt, yt), "jtprod": T.jtprod(xt, yt),
        "jprod": T.jprod(xt, vt), "jtprod_ones": T.jtprod_ones(xt),
        "grad_lag_hi": T.grad_lag_hi(xt, yt, torch.as_tensor(mu)),
        "jtprod_hi": T.jtprod_hi(xt, yt), "a_of_hi": T.a_of_hi(xt),
        "hess_prod_fn": T.hess_prod_fn(xt, yt)(vt),
    }
    wc_t, bnd_t = T.split_canonical_sq(yt)
    Jc_t = out["jac_orig"]
    H_t = out["lag_hess"]
    Q_t = T.jtdj_fused(Jc_t, yt, H_t)
    for b in range(B):
        x, y, v = (jnp.asarray(a[b]) for a in (X, Y, V))
        want = {
            "f": J.f(x), "c": J.c(x), "a_of": J.a_of(x),
            "grad_f": J.grad_f(x), "jac_orig": J.jac_orig(x),
            "lag_hess": J.lag_hess(x, y), "jtprod": J.jtprod(x, y),
            "jprod": J.jprod(x, v), "jtprod_ones": J.jtprod_ones(x),
            "grad_lag_hi": J.grad_lag_hi(x, y, mu[b]),
            "jtprod_hi": J.jtprod_hi(x, y), "a_of_hi": J.a_of_hi(x),
            "hess_prod_fn": J.hess_prod_fn(x, y)(v),
        }
        for k, w in want.items():
            _close(out[k][b], w)
        wc_j, bnd_j = J.split_canonical_sq(y)
        _close(wc_t[b], wc_j)
        _close(bnd_t[b], bnd_j)
        Jc_j, H_j = J.jac_orig(x), J.lag_hess(x, y)
        _close(Q_t[b], J.jtdj_fused(Jc_j, y, H_j))
        _close(T.jprod_mat(Jc_t, vt)[b], J.jprod_mat(Jc_j, v))
        _close(T.jtprod_mat(Jc_t, yt)[b], J.jtprod_mat(Jc_j, y))


def test_c_jtprod_matches_separate_products():
    """The line search's fused c + J^T products equal the separate VJPs."""
    _, tspec = zoo_pair("hs071")
    T = tnlp.canonicalize(tspec, device="cpu")
    x = torch.tensor([[1.2, 4.1, 3.9, 1.3], [1.0, 4.7, 3.8, 1.4]],
                     dtype=torch.float64)
    w1 = torch.tensor([[0.5, -1.0], [2.0, 0.25]], dtype=torch.float64)
    w2 = torch.ones_like(w1)
    cval, (j1, j2) = T.c_jtprod(x, [w1, w2])
    torch.testing.assert_close(cval, T.c(x), rtol=0, atol=0)
    torch.testing.assert_close(j1, T._vjp_c(x, w1), rtol=0, atol=0)
    torch.testing.assert_close(j2, T._vjp_c(x, w2), rtol=0, atol=0)


def test_unsupported_spec_fields_raise():
    """A constraint body without its bounds raises; `pdata` and `jac` are
    ported (tests/test_torch_parametric.py holds them to the JAX package):
    a parametric spec canonicalizes and its oracles call f and c with the
    instance's data."""
    with pytest.raises(ValueError, match="lcon/ucon"):
        tnlp.NLPSpec(f=lambda x: x.sum(), c=lambda x: x, x0=np.zeros(2))
    _, tspec = zoo_pair("circle1")
    f, c = tspec.f, tspec.c
    tspec.f = lambda x, pd: f(x) + pd["a"] @ x
    tspec.c = lambda x, pd: c(x)
    tspec.pdata = {"a": np.ones(2)}
    T = tnlp.canonicalize(tspec, device="cpu")
    assert T.parametric
    x = torch.tensor([[0.5, 0.25]], dtype=torch.float64)
    pd = {"a": torch.tensor([[2.0, 1.0]], dtype=torch.float64)}
    assert float(T.f(x)[0]) == float(f(x[0])) + 0.75       # the template
    assert float(T.f(x, pd)[0]) == float(f(x[0])) + 1.25   # its own data
