"""The port's MPS reader and writer (models/lp.py) against the JAX
package's: `read_mps_data` gives the same arrays on every file of
results/lpi_mps/, `write_mps` then `read_mps` round-trips random LPData,
and `read_mps` builds a spec whose oracles equal the JAX spec's."""

from pathlib import Path

import numpy as np
import pytest
import torch

import onephase_tpu.models.lp as jlp
import onephase_tpu_torch.models.lp as tlp
import onephase_tpu_torch.nlp as tnlp

MPS_DIR = Path(__file__).resolve().parent.parent / "results" / "lpi_mps"
FILES = sorted(p.name for p in MPS_DIR.glob("*.mps"))
FIELDS = ("cvec", "A", "lcon", "ucon", "lvar", "uvar")


def _assert_same(dt, dj):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f), f)
    assert (dt.name, dt.c0, dt.objsense, dt.x0) == \
        (dj.name, dj.c0, dj.objsense, dj.x0)


def test_every_file_is_read():
    assert len(FILES) == 23


@pytest.mark.parametrize("name", FILES)
def test_read_mps_data_matches_jax(name):
    path = str(MPS_DIR / name)
    _assert_same(tlp.read_mps_data(path), jlp.read_mps_data(path))


def _random_lp(rng, m, n):
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.5)
    lcon = rng.normal(size=m) - 1.0
    ucon = lcon + rng.uniform(0.5, 2.0, m)
    ucon[0] = lcon[0]                       # an equality row
    lcon[1] = -np.inf                       # an L row
    ucon[2] = np.inf                        # a G row
    lvar = rng.normal(size=n) - 2.0
    uvar = lvar + rng.uniform(0.5, 3.0, n)
    lvar[0], uvar[0] = -np.inf, np.inf      # free
    lvar[1] = -np.inf                       # MI + UP
    uvar[2] = np.inf                        # LO only
    uvar[3] = lvar[3]                       # fixed
    return tlp.LPData(cvec=rng.normal(size=n), A=A, lcon=lcon, ucon=ucon,
                      lvar=lvar, uvar=uvar, name="rand", c0=1.25)


@pytest.mark.parametrize("gz", [False, True])
def test_write_read_round_trip(tmp_path, gz):
    d = _random_lp(np.random.default_rng(5), 7, 9)
    path = str(tmp_path / ("rand.mps.gz" if gz else "rand.mps"))
    tlp.write_mps(d, path)
    back = tlp.read_mps_data(path)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(d, f), f)
    assert back.c0 == d.c0 and back.name == "rand"
    # the JAX writer writes the same file
    jpath = str(tmp_path / ("j.mps.gz" if gz else "j.mps"))
    jlp.write_mps(jlp.LPData(**{f: getattr(d, f) for f in
                                FIELDS + ("name", "c0")}), jpath)
    _assert_same(tlp.read_mps_data(jpath), back)


def test_read_mps_spec_matches_jax():
    """read_mps's NLPSpec: the same bounds and, at random points, the same
    objective and constraint values (float64, exact data)."""
    import jax.numpy as jnp

    import onephase_tpu.nlp as jnlp
    path = str(MPS_DIR / "lpi_klein1.mps")
    ts = tlp.read_mps(path, device="cpu")
    js = jlp.read_mps(path)
    for f in ("lcon", "ucon", "lvar", "uvar", "x0"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    assert ts.name == js.name and tuple(ts.lin) == tuple(js.lin)
    T = tnlp.canonicalize(ts, device="cpu")
    J = jnlp.canonicalize(js, dtype=jnp.float64)
    x = np.random.default_rng(0).normal(size=(2, T.n))
    xt = torch.as_tensor(x)
    for b in range(2):
        np.testing.assert_allclose(T.c(xt)[b].numpy(),
                                   np.asarray(J.c(jnp.asarray(x[b]))),
                                   rtol=1e-14, atol=1e-12)
        np.testing.assert_allclose(float(T.f(xt)[b]),
                                   float(J.f(jnp.asarray(x[b]))),
                                   rtol=1e-14)
