"""The port's campaign harness (harness.py) against the JAX package's:
resume by skipping solved problems, the benchmark-tables CSV in the JAX
package's format with its rows, the per-problem logs, histories and par.txt, the
multi-host shard and merge with explicit process indices, the parity
report, and run_lp_directory on small MPS files of results/lpi_mps/ with
the JAX package's statuses.  Float64 on the CPU."""

import csv
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import onephase_tpu.harness as jh
import onephase_tpu_torch.harness as th
from onephase_tpu.config import Params as JParams
from onephase_tpu.models import zoo as jzoo
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.models import zoo as tzoo
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MPS_DIR = Path(__file__).resolve().parent.parent / "results" / "lpi_mps"
BASE = {"term!max_it": 81, "a_norm_penalty": 1e-4, "output_level": 0}


def _pars():
    return JParams().with_overrides(BASE), TParams().with_overrides(BASE)


def _problems(names):
    return ({n: getattr(jzoo, n)() for n in names},
            {n: getattr(tzoo, n)() for n in names})


def _rows_but_time(path):
    """The CSV's rows with the time column blanked (the one column whose
    value is the machine's), each field checked to be written as the JAX
    package writes it (Python's repr of an int or a float)."""
    with open(path) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["name", "it", "time", "fval", "con", "status"]
    for r in rows[1:]:
        assert r[1] == repr(int(r[1]))
        for v in r[2:5]:
            assert v == repr(float(v)), v
    return [rows[0]] + [r[:2] + ["-"] + r[3:] for r in rows[1:]]


def _same_rows(path_t, path_j):
    """The port's CSV rows against the JAX package's: names, iterations
    and statuses equal, objective and violation to 1e-8 relative (the same
    float64 solves; their last bits are each package's)."""
    rt, rj = _rows_but_time(path_t), _rows_but_time(path_j)
    assert len(rt) == len(rj)
    for a, b in zip(rt[1:], rj[1:]):
        assert (a[0], a[1], a[5]) == (b[0], b[1], b[5])
        for i in (3, 4):
            assert float(a[i]) == pytest.approx(float(b[i]), rel=1e-8,
                                                abs=1e-12)


def test_table_status_equal():
    assert th.TABLE_STATUS == jh.TABLE_STATUS
    assert [f for f in th.ProblemSummary.__dataclass_fields__] == \
        [f for f in jh.ProblemSummary.__dataclass_fields__]


def test_resume_csv_and_artifacts(tmp_path):
    jp, tp = _pars()
    jprobs, tprobs = _problems(["toy_lp1", "toy_lp_inf1"])
    s_j = jh.run_problems(jprobs, "campaign", pars=jp,
                          out_root=str(tmp_path / "jax"))
    s1 = th.run_problems(tprobs, "campaign", pars=tp,
                         out_root=str(tmp_path / "port"), device="cpu")
    assert s1["toy_lp1"].status == "optimal"
    assert s1["toy_lp_inf1"].status == "primal_infeasible"
    out, jout = tmp_path / "port" / "campaign", tmp_path / "jax" / "campaign"
    # the CSV: the JAX package's format and rows
    _same_rows(out / "summary.csv", jout / "summary.csv")
    for name in tprobs:
        assert (out / "log" / f"{name}.txt").exists()
        hist_t = json.loads((out / "hist" / f"{name}.json").read_text())
        hist_j = json.loads((jout / "hist" / f"{name}.json").read_text())
        assert [h["t"] for h in hist_t] == [h["t"] for h in hist_j]
        for k in ("status", "it_count", "number_variables",
                  "number_constraints"):
            assert getattr(s1[name], k) == getattr(s_j[name], k), k
    assert (out / "par.txt").read_text() == (jout / "par.txt").read_text()
    assert "SPAN" in (out / "timer.txt").read_text()
    # resume: nothing re-runs (a solve would raise), the summary is kept
    s2 = th.run_problems(tprobs, "campaign", pars=tp,
                         out_root=str(tmp_path / "port"),
                         solve_func=lambda *a: 1 / 0, device="cpu")
    assert {k: v.status for k, v in s2.items()} == \
        {k: v.status for k, v in s1.items()}
    assert set(json.loads((out / "summary.json").read_text())) == set(tprobs)


def test_solve_errors_are_recorded_not_raised(tmp_path):
    """The harness survives a failing solve: status ERR with the error in
    the problem's log, as in the JAX package (harness.py:129-134)."""
    _, tp = _pars()

    def boom(spec, pars):
        raise RuntimeError("kaput")

    s = th.run_problems({"p": tzoo.toy_lp1()}, "err", pars=tp,
                        out_root=str(tmp_path), solve_func=boom,
                        device="cpu")
    assert s["p"].status == "ERR"
    assert "kaput" in (tmp_path / "err" / "log" / "p.txt").read_text()


def test_multihost_shard_and_merge(tmp_path):
    """Two hosts with explicit indices: the first to finish reports None,
    the last merges; the shards are disjoint and complete, as the JAX
    package's are."""
    jp, tp = _pars()
    names = ["toy_lp1", "toy_lp_inf1", "toy_lp2"]
    jprobs, tprobs = _problems(names)
    out0 = th.run_problems_multihost(tprobs, "mh", pars=tp,
                                     out_root=str(tmp_path),
                                     process_index=0, process_count=2,
                                     device="cpu")
    assert out0 is None
    merged = th.run_problems_multihost(tprobs, "mh", pars=tp,
                                       out_root=str(tmp_path),
                                       process_index=1, process_count=2,
                                       device="cpu")
    assert set(merged) == set(names)
    assert merged["toy_lp1"].status == "optimal"
    assert merged["toy_lp_inf1"].status == "primal_infeasible"
    h = [json.load(open(tmp_path / "mh" / f"host{i}" / "summary.json"))
         for i in range(2)]
    assert set(h[0]).isdisjoint(h[1]) and set(h[0]) | set(h[1]) == set(names)
    # the JAX package shards the same names the same way
    for i in range(2):
        jh.run_problems_multihost(jprobs, "mh", pars=jp,
                                  out_root=str(tmp_path / "jax"),
                                  process_index=i, process_count=2)
        hj = json.load(open(tmp_path / "jax" / "mh" / f"host{i}" /
                            "summary.json"))
        assert set(hj) == set(h[i])
    _same_rows(tmp_path / "mh" / "summary.csv",
               tmp_path / "jax" / "mh" / "summary.csv")


def test_multihost_empty_shard_still_merges(tmp_path):
    _, tp = _pars()
    tprobs = {"lp1": tzoo.toy_lp1(), "lp2": tzoo.toy_lp2()}
    outs = [th.run_problems_multihost(tprobs, "mh_empty", pars=tp,
                                      out_root=str(tmp_path),
                                      process_index=pi, process_count=3,
                                      device="cpu")
            for pi in range(3)]
    merged = next(o for o in outs if o is not None)
    assert set(merged) == set(tprobs)
    assert json.load(open(tmp_path / "mh_empty" / "host2" /
                          "summary.json")) == {}


def test_process_identity_defaults():
    """Without explicit indices and without a torch.distributed group the
    process is 0 of 1 (the JAX package reads jax.process_index/count)."""
    assert th._process_identity(None, None) == (0, 1)
    assert th._process_identity(2, 3) == (2, 3)


def test_compare_to_reference(tmp_path):
    _, tp = _pars()
    ref_csv = tmp_path / "ref.csv"
    ref_csv.write_text("name,it,time,fval,con,status\n"
                       "lp1,7,0.1,-100.0,0.0,optimal\n")
    s = th.run_problems({"lp1": tzoo.toy_lp1()}, "cmp", pars=tp,
                        out_root=str(tmp_path), device="cpu")
    rep = th.compare_to_reference(s, str(ref_csv))
    assert rep == jh.compare_to_reference(s, str(ref_csv))
    assert rep["lp1"]["status_match"]


def test_run_lp_directory_matches_jax(tmp_path):
    """Three small MPS files of results/lpi_mps/ through run_lp_directory
    in float64: the JAX package's statuses, iterations and objectives; the
    summary files in its format."""
    d = tmp_path / "mps"
    d.mkdir()
    for name in ("lpi_galenet", "lpi_itest2", "lpi_itest6"):
        shutil.copy(MPS_DIR / f"{name}.mps", d / f"{name}.mps")
    (d / "README").write_text("not an LP")
    opts = {"output_level": 0, "term.max_it": 120, "term.tol_inf_2": 1e-3}
    sj = jh.run_lp_directory(str(d), "lpd", JParams().with_overrides(opts),
                             out_root=str(tmp_path / "jax"), round_to=16)
    st = th.run_lp_directory(str(d), "lpd", TParams().with_overrides(opts),
                             out_root=str(tmp_path / "port"), round_to=16,
                             device="cpu")
    assert set(st) == set(sj) == {"lpi_galenet", "lpi_itest2", "lpi_itest6"}
    for k in st:
        assert st[k].status == sj[k].status == "primal_infeasible", k
        assert st[k].it_count == sj[k].it_count, k
        assert st[k].fval == pytest.approx(sj[k].fval, rel=1e-8), k
    out = tmp_path / "port" / "lpd"
    payload = json.loads((out / "summary.json").read_text())
    assert payload["_campaign"]["n_problems"] == 3
    assert set(payload) == set(json.loads(
        (tmp_path / "jax" / "lpd" / "summary.json").read_text()))
    assert (out / "par.txt").exists()
    rows = _rows_but_time(out / "summary.csv")
    assert len(rows) == 4 and all(r[-1] == "primal_infeasible"
                                  for r in rows[1:])
    assert np.isfinite(float(rows[1][3]))


def test_profile_dir_writes_a_trace(tmp_path):
    _, tp = _pars()
    s = th.run_problems({"lp1": tzoo.toy_lp1()}, "prof", pars=tp,
                        out_root=str(tmp_path), device="cpu",
                        profile_dir=str(tmp_path / "trace"))
    assert s["lp1"].status == "optimal"
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
