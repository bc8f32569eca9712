"""The port's framework-free pieces against the JAX package: the parameter
tree, the status codes, the package's import hygiene (no JAX, no triton,
no nvcc needed to import) and its entry points' default device (the CUDA
card, or an error that says to pass device="cpu")."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

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


# the precision knobs and the Mehrotra init: ported to the dense path
PORTED_KNOBS = ({"kkt.factor_precision": "f32"},
                {"kkt.factor_precision": "f32_fallback",
                 "kkt.fallback_form_f32": True},
                {"kkt.hi_matvec_f32pair": "refine"},
                {"kkt.hi_matvec_f32pair": "all"},
                {"kkt.precond_f32": True},
                {"kkt.q_form_dtype": "bf16"},
                {"kkt.residual_precision": "f64"},
                {"init.init_style": "mehrotra"})


def test_unported_options_raise():
    """The dense kernel takes every ported knob, `make_kernel` builds every
    KKT system (symmetric and clever_symmetric, also with the eigh
    backend, and schur_dual on an LP), refuses a value no package knows
    and the JAX package's invalid combinations (ValueError) and still
    refuses the unported options; the structured kernels refuse the
    dense-only knobs (NotImplementedError; the banded kernel's
    factor_precision check is the JAX package's ValueError)."""
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.ipm.dual import SchurDualKernel, make_kernel
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.models.lp import lp_spec
    from onephase_tpu_torch.parallel.banded import BandedKernel
    from onephase_tpu_torch.parallel.chain import ChainKernel
    nlp = onephase_tpu_torch.canonicalize(zoo.circle1(), device="cpu")
    lp = onephase_tpu_torch.canonicalize(lp_spec(
        [1.0, 2.0], [[1.0, 1.0]], [1.0], [2.0], [0.0, 0.0], [3.0, 3.0],
        device="cpu"), device="cpu")
    for over in PORTED_KNOBS:
        make_kernel(nlp, tcfg.Params().with_overrides(over))
    for over in ({"kkt.kkt_solver_type": "symmetric"},
                 {"kkt.kkt_solver_type": "symmetric",
                  "kkt.linear_solver_type": "eigh"},
                 {"kkt.kkt_solver_type": "clever_symmetric",
                  "kkt.kkt_system_rescale": "u_and_x"},
                 {"kkt.kkt_solver_type": "clever_symmetric",
                  "kkt.linear_solver_type": "eigh"}):
        k = make_kernel(nlp, tcfg.Params().with_overrides(over))
        assert type(k) is OnePhaseKernel and k.kkt_type == \
            over["kkt.kkt_solver_type"]
    dual = {"kkt.kkt_solver_type": "schur_dual"}
    for over in (dual, dict(dual, **{"kkt.factor_precision": "f32"})):
        k = make_kernel(lp, tcfg.Params().with_overrides(over))
        assert type(k) is SchurDualKernel
    for over in ({"matmul_precision": "high"},
                 {"kkt.linear_solver_type": "cholmod"}):
        with pytest.raises(NotImplementedError):
            make_kernel(nlp, tcfg.Params().with_overrides(over))
    for prob, over in (
            (nlp, {"kkt.factor_precision": "f16"}),
            (nlp, {"kkt.q_form_dtype": "fp8"}),
            (nlp, {"init.init_style": "mehrotra2"}),
            (nlp, {"kkt.kkt_solver_type": "ldl"}),
            (nlp, {"kkt.kkt_solver_type": "symmetric",
                   "kkt.factor_precision": "f32"}),
            (nlp, {"kkt.kkt_solver_type": "clever_symmetric",
                   "kkt.kkt_system_rescale": "x_only"}),
            (nlp, dual),                               # a Hessian
            (lp, dict(dual, **{"kkt.factor_precision": "f32_fallback"}))):
        with pytest.raises(ValueError):
            make_kernel(prob, tcfg.Params().with_overrides(over))
    spec = chain_ocp(K=4, nx=2, mc=1, device="cpu")
    flat = onephase_tpu_torch.canonicalize(spec.to_nlpspec(), device="cpu")
    for over in PORTED_KNOBS:
        pars = tcfg.Params().with_overrides(
            dict(over, **{"kkt.linear_solver_type": "xla"}))
        with pytest.raises(NotImplementedError):
            ChainKernel(spec, pars, device="cpu")
        err = (ValueError if "kkt.factor_precision" in over
               else NotImplementedError)
        with pytest.raises(err):
            BandedKernel(flat, pars, device="cpu")


def _entry_call(entry):
    """A call of the entry point `entry` that gives it no device."""
    from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.models.lp import lp_spec
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.parallel.chain import ChainKernel
    pars = tcfg.Params().with_overrides({"output_level": 0})
    if entry == "ChainKernel":
        spec = chain_ocp(K=4, nx=2, mc=1, device="cpu")
        return lambda: ChainKernel(spec, pars)
    if entry == "BandedKernel":
        from onephase_tpu_torch.parallel.banded import BandedKernel
        nlp = onephase_tpu_torch.canonicalize(
            chain_ocp(K=4, nx=2, mc=1, device="cpu").to_nlpspec(),
            device="cpu")
        return lambda: BandedKernel(nlp, pars)
    if entry == "state_from_numpy":
        k = OnePhaseKernel(onephase_tpu_torch.canonicalize(
            zoo.circle1(), device="cpu"), pars)
        tree = state_to_numpy(k.initial_state())
        return lambda: state_from_numpy(tree)
    return {
        "canonicalize": lambda: onephase_tpu_torch.canonicalize(
            zoo.circle1()),
        "one_phase_solve": lambda: onephase_tpu_torch.one_phase_solve(
            zoo.circle1(), pars),
        "make_qp": lambda: make_qp(8, 4),
        "chain_ocp": lambda: chain_ocp(K=4, nx=2, mc=1),
        "lp_spec": lambda: lp_spec([1.0], [[1.0]], [0.0], [1.0]),
    }[entry]


@pytest.mark.parametrize("entry", [
    "canonicalize", "one_phase_solve", "make_qp", "chain_ocp",
    "ChainKernel", "BandedKernel", "state_from_numpy", "lp_spec"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a device and without a card every entry point raises and
    says how to ask for the CPU; it never carries on quietly there."""
    call = _entry_call(entry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
