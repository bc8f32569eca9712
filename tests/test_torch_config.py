"""The port's framework-free pieces against the JAX package: the parameter
tree, the status codes, and the package's import hygiene (no JAX, no
triton, no nvcc needed to import)."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import onephase_tpu.config as jcfg
import onephase_tpu.ipm.state as jstate
import onephase_tpu_torch
import onephase_tpu_torch.config as tcfg
import onephase_tpu_torch.ipm.state as tstate

PKG = Path(onephase_tpu_torch.__file__).resolve().parent


def test_params_flat_identical():
    assert tcfg.Params().flat() == jcfg.Params().flat()


@pytest.mark.parametrize("over", [
    {"term!max_it": 100, "ls.dual_ls": 2},
    {"kkt.linear_solver_type": "pallas", "a_norm_penalty": 1e-4},
    {"delta.max": 10, "term.tol_opt": 1e-4, "chunk_size": 20},
])
def test_with_overrides_same(over):
    assert (tcfg.Params().with_overrides(over).flat()
            == jcfg.Params().with_overrides(over).flat())


@pytest.mark.parametrize("over, err", [
    ({"term!nope": 1}, KeyError),
    ({"term.max_it": "ten"}, TypeError),
])
def test_with_overrides_same_errors(over, err):
    for P in (tcfg.Params, jcfg.Params):
        with pytest.raises(err):
            P().with_overrides(over)


def test_status_and_ls_codes_equal():
    names = [k for k in dir(jstate)
             if k.isupper() and isinstance(getattr(jstate, k), (int, dict))]
    assert names
    for k in names:
        assert getattr(tstate, k) == getattr(jstate, k), k


def _modules():
    return sorted(p for p in PKG.rglob("*.py"))


def test_no_jax_import_anywhere():
    for path in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "onephase_tpu", "triton"), \
                    f"{path.relative_to(PKG)} imports {mod}"


def test_every_module_imports_without_nvcc_or_gpu():
    names = [m.name for m in pkgutil.walk_packages([str(PKG)],
                                                   "onephase_tpu_torch.")]
    assert "onephase_tpu_torch.ops.cholesky" in names
    for name in names:
        importlib.import_module(name)


def test_unported_options_raise():
    from onephase_tpu_torch.ipm.core import make_kernel
    from onephase_tpu_torch.models import zoo
    nlp = onephase_tpu_torch.canonicalize(zoo.circle1())
    for over in ({"kkt.kkt_solver_type": "symmetric"},
                 {"kkt.kkt_solver_type": "schur_dual"},
                 {"kkt.factor_precision": "f32"},
                 {"kkt.q_form_dtype": "bf16"},
                 {"kkt.residual_precision": "f64"},
                 {"kkt.precond_f32": True},
                 {"init.init_style": "mehrotra"}):
        with pytest.raises(NotImplementedError):
            make_kernel(nlp, tcfg.Params().with_overrides(over))
