"""The port's command-line front-end (cli.py) against the JAX package's:
the same parser (flags, defaults and choices; `--platform` names the
device), the same problem sets, and tests/test_harness.py's smoke case
run through both, with the same statuses and outer iterations, and its
resume on a second call.  On the CPU, float64 (`--x64`)."""

import csv

import pytest

import onephase_tpu.cli as jcli
import onephase_tpu_torch.cli as tcli
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    ja, ta = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert set(ta) == set(ja)
    for dest in ja:
        if dest == "platform":
            continue
        assert ta[dest] == ja[dest], dest
    # the device: the card by default, or the CPU by name
    assert ta["platform"][1:] == ("cuda", ["cuda", "cpu"])
    assert tcli.build_parser().parse_args([]).linear_solver == "xla"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--linear-solver", "invchol"])


def _rows(path):
    with open(path) as fh:
        return {r["name"]: (r["it"], r["status"]) for r in csv.DictReader(fh)}


ARGS = ["--problem-set", "netlib_infeasible", "--max-it", "200",
        "--output-level", "0", "--test-name", "cli_smoke"]


def test_cli_smoke_matches_jax_and_resumes(tmp_path, capsys):
    jcli.main(ARGS + ["--output-dir", str(tmp_path / "jax"), "--x64"])
    capsys.readouterr()
    summary = tcli.main(ARGS + ["--output-dir", str(tmp_path / "port"),
                                "--platform", "cpu", "--x64"])
    out = capsys.readouterr().out
    assert "4 problems: 0 optimal, 4 infeasible, 0 other" in out
    assert all(v.status == "primal_infeasible" for v in summary.values())
    csv_t = tmp_path / "port" / "cli_smoke" / "summary.csv"
    assert _rows(csv_t) == _rows(tmp_path / "jax" / "cli_smoke" /
                                 "summary.csv")
    # a second call into the same directory skips every problem
    tcli.main(ARGS + ["--output-dir", str(tmp_path / "port"),
                      "--platform", "cpu", "--x64"])
    out = capsys.readouterr().out
    assert out.count("already solved") == 4 and "RUNNING" not in out


@pytest.mark.parametrize("problem_set", ["zoo", "netlib_feasible",
                                         "netlib_infeasible", "econ",
                                         "examples"])
def test_problem_sets_match_jax(problem_set):
    """Each problem set names the JAX package's problems with the same
    shapes and bounds."""
    import numpy as np
    args = tcli.build_parser().parse_args(["--problem-set", problem_set])
    tp = tcli.get_problems(args, "cpu")
    jp = jcli.get_problems(jcli.build_parser().parse_args(
        ["--problem-set", problem_set]))
    assert list(tp) == list(jp)
    for k in jp:
        for f in ("x0", "lvar", "uvar", "lcon", "ucon"):
            np.testing.assert_array_equal(getattr(tp[k], f),
                                          getattr(jp[k], f), f"{k}.{f}")
