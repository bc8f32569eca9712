"""The port's Netlib-style suites (models/netlib.py) against the JAX
package's: the same seed gives the same LPs array for array.  LPData
suites are compared field by field; NLPSpec suites by their bounds, start
and linear rows, and by their constraint matrix and objective read off
the oracles (c at the unit vectors, f at zero and at the unit vectors),
exactly in float64."""

import numpy as np
import pytest
import torch
from torch.func import vmap

import onephase_tpu.models.netlib as jnet
import onephase_tpu_torch.models.netlib as tnet

FIELDS = ("cvec", "A", "lcon", "ucon", "lvar", "uvar", "x0")


def _same_data(dt, dj):
    for f in FIELDS:
        a, b = getattr(dt, f), getattr(dj, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, f)
    assert (dt.name, dt.c0, dt.objsense) == (dj.name, dj.c0, dj.objsense)


def _same_spec(ts, js):
    import jax
    import jax.numpy as jnp
    for f in ("lcon", "ucon", "lvar", "uvar", "x0"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    assert ts.name == js.name and tuple(ts.lin) == tuple(js.lin)
    assert (ts.constant_jac, ts.constant_hess, ts.zero_hess) == \
        (js.constant_jac, js.constant_hess, js.zero_hess)
    n = ts.x0.shape[0]
    eye = np.eye(n)
    cols_t = vmap(ts.c)(torch.as_tensor(eye)).numpy()
    cols_j = np.asarray(jax.vmap(js.c)(jnp.asarray(eye)))
    np.testing.assert_array_equal(cols_t, cols_j)
    f_t = vmap(ts.f)(torch.as_tensor(np.vstack([np.zeros(n), eye])))
    f_j = jax.vmap(js.f)(jnp.asarray(np.vstack([np.zeros(n), eye])))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def _same_suite(tsuite, jsuite, same):
    assert list(tsuite) == list(jsuite)
    for k in jsuite:
        same(tsuite[k], jsuite[k])


def test_lpi_dims_equal():
    assert tnet.LPI_DIMS == jnet.LPI_DIMS
    assert tnet._MECHANISMS == jnet._MECHANISMS


@pytest.mark.parametrize("seed", [0, 4])
def test_feasible_suite(seed):
    _same_suite(tnet.feasible_suite(seed=seed, device="cpu"),
                jnet.feasible_suite(seed=seed), _same_spec)


def test_infeasible_suite():
    _same_suite(tnet.infeasible_suite(device="cpu"), jnet.infeasible_suite(),
                _same_spec)


def test_lpi_suite_data_and_specs():
    _same_suite(tnet.lpi_suite(max_n=1500, as_data=True),
                jnet.lpi_suite(max_n=1500, as_data=True), _same_data)
    _same_suite(tnet.lpi_suite(max_n=100, device="cpu"),
                jnet.lpi_suite(max_n=100), _same_spec)


@pytest.mark.parametrize("kw", [{"n_pairs": 48, "max_n": 600},
                                {"n_pairs": 3, "seed": 2, "max_n": 100}])
def test_mixed_suite(kw):
    _same_suite(tnet.mixed_suite(**kw), jnet.mixed_suite(**kw), _same_data)


def test_mixed_suite_specs():
    _same_suite(tnet.mixed_suite(n_pairs=2, max_n=100, as_data=False,
                                 device="cpu"),
                jnet.mixed_suite(n_pairs=2, max_n=100, as_data=False),
                _same_spec)


@pytest.mark.parametrize("args", [(1024, 512, 2, 0.5), (64, 32, 3, None)])
def test_sized_mixed_suite(args):
    n, m, pairs, density = args
    _same_suite(tnet.sized_mixed_suite(n, m, pairs, density=density),
                jnet.sized_mixed_suite(n, m, pairs, density=density),
                _same_data)


def test_load_netlib(tmp_path):
    from onephase_tpu_torch.models.lp import write_mps
    data = tnet.lpi_suite(max_n=40, as_data=True)
    for name, d in data.items():
        write_mps(d, str(tmp_path / f"{name}.mps"))
    (tmp_path / "notes.txt").write_text("not an LP")
    _same_suite(tnet.load_netlib(str(tmp_path), device="cpu"),
                jnet.load_netlib(str(tmp_path)), _same_spec)
