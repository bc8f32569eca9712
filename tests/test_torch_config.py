"""The port's framework-free pieces against the JAX package: the parameter
tree, the status codes, the package's import hygiene (no JAX, no triton,
no nvcc needed to import) and its entry points' default device (the CUDA
card, or an error that says to pass device="cpu")."""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
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


# the campaign path's modules (the bucketed LP driver and its front end)
CAMPAIGN_MODULES = ("harness", "cli", "model", "baselines", "autotune",
                    "models.netlib", "parallel.buckets",
                    "parallel.checkpoint")


def _imports(path):
    """Every module name an `import` statement of the file names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_jax_import_anywhere():
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    assert {"ops/block_schur.py", "parallel/scenario.py",
            "models/tax.py", "parallel/mesh.py", "dryrun.py"} <= names
    assert {m.replace(".", "/") + ".py" for m in CAMPAIGN_MODULES} <= names
    for path in _modules():
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "onephase_tpu", "triton"), \
                f"{path.relative_to(PKG)} imports {mod}"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the card's machine without JAX: no import of
    jax or of the JAX package anywhere in it (it names onephase_tpu/ files
    only as strings)."""
    path = PKG.parent / "chip_smoke.py"
    mods = list(_imports(path))
    assert any(m.startswith("onephase_tpu_torch") for m in mods)
    for mod in mods:
        assert mod.split(".")[0] not in ("jax", "jaxlib", "onephase_tpu"), mod


def test_every_module_imports_without_nvcc_or_gpu():
    names = [m.name for m in pkgutil.walk_packages([str(PKG)],
                                                   "onephase_tpu_torch.")]
    for mod in ("ops.cholesky", "ops.block_schur", "parallel.scenario",
                "models.examples", "models.tax", "parallel.mesh",
                "dryrun") + CAMPAIGN_MODULES:
        assert f"onephase_tpu_torch.{mod}" in names
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
    and the JAX package's invalid combinations (ValueError) and an
    unported linear solver (NotImplementedError).  The structured kernels
    take the dense-path knobs as the JAX package's do
    (tests/test_torch_structured_options.py)
    and a mesh (parallel/mesh.py; tests/test_torch_mesh.py): a one-rank
    mesh here, on the chain and banded kernels with partitions.

    `matmul_precision` (ops/precision.py): on the CPU "high" builds every
    kernel, the chain and banded `pallas` lanes included; a card-only preset
    (BF16_BF16_F32_X3) and a value no package knows raise ValueError.  On
    a card every accepted name runs on every lane, K5 and K7 included
    (tests/test_torch_gpu.py, chip_smoke.py's precision phase)."""
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.ipm.dual import SchurDualKernel, make_kernel
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.models.lp import lp_spec
    from onephase_tpu_torch.parallel.banded import BandedKernel
    from onephase_tpu_torch.models.examples import two_stage_qp
    from onephase_tpu_torch.parallel.chain import ChainKernel
    from onephase_tpu_torch.parallel.scenario import ScenarioKernel
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
    with pytest.raises(NotImplementedError):
        make_kernel(nlp, tcfg.Params().with_overrides(
            {"kkt.linear_solver_type": "cholmod"}))
    make_kernel(nlp, tcfg.Params().with_overrides({"matmul_precision":
                                                   "high"}))
    make_kernel(lp, tcfg.Params().with_overrides(
        dict(dual, matmul_precision="high")))
    for prob, over in (
            (nlp, {"kkt.factor_precision": "f16"}),
            (nlp, {"kkt.q_form_dtype": "fp8"}),
            (nlp, {"init.init_style": "mehrotra2"}),
            (nlp, {"kkt.kkt_solver_type": "ldl"}),
            (nlp, {"matmul_precision": "BF16_BF16_F32_X3"}),   # card only
            (nlp, {"matmul_precision": "fastest"}),            # no package
            (lp, dict(dual, matmul_precision="BF16_BF16_F32_X3")),
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
    scen = two_stage_qp(device="cpu")
    structured = (lambda p, **kw: ChainKernel(spec, p, device="cpu", **kw),
                  lambda p, **kw: BandedKernel(flat, p, device="cpu", **kw),
                  lambda p, **kw: ScenarioKernel(scen, p, device="cpu", **kw))
    xla = {"kkt.linear_solver_type": "xla"}
    parts = dict(xla, **{"kkt.chain_partitions": 2})
    from onephase_tpu_torch.parallel.mesh import make_mesh
    pallas = {"kkt.linear_solver_type": "pallas"}
    for make, axis, over in zip(structured, ("chain", "chain", "blk"),
                                (parts, parts, xla)):
        make(tcfg.Params().with_overrides(xla))
        for lane in (xla, pallas):
            make(tcfg.Params().with_overrides(
                dict(lane, matmul_precision="high")))
            with pytest.raises(ValueError):
                make(tcfg.Params().with_overrides(
                    dict(lane, matmul_precision="BF16_BF16_F32_X3")))
        k = make(tcfg.Params().with_overrides(over),
                 mesh=make_mesh(axis=axis, device="cpu"))
        assert k.mesh.size == 1


def _entry_call(entry):
    """A call of the entry point `entry` that gives it no device."""
    from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.models import examples, tax, zoo
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.models.lp import lp_spec
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.parallel.chain import ChainKernel
    pars = tcfg.Params().with_overrides({"output_level": 0})
    if entry == "ScenarioKernel":
        from onephase_tpu_torch.parallel.scenario import ScenarioKernel
        spec = examples.two_stage_qp(device="cpu")
        return lambda: ScenarioKernel(spec, pars)
    if entry in MODEL_FNS:
        return lambda: getattr(examples if hasattr(examples, entry)
                               else tax, entry)()
    if entry == "ChainKernel":
        spec = chain_ocp(K=4, nx=2, mc=1, device="cpu")
        return lambda: ChainKernel(spec, pars)
    if entry == "BandedKernel":
        from onephase_tpu_torch.parallel.banded import BandedKernel
        nlp = onephase_tpu_torch.canonicalize(
            chain_ocp(K=4, nx=2, mc=1, device="cpu").to_nlpspec(),
            device="cpu")
        return lambda: BandedKernel(nlp, pars)
    if entry in CAMPAIGN_ENTRIES:
        return _campaign_entry(entry)
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


# the example families and the tax models
MODEL_FNS = ("largest_small_polygon", "electron", "max_cut", "kissing",
            "chain", "two_stage_qp", "tax1d", "tax_grouped")
# the campaign path's entry points
CAMPAIGN_ENTRIES = ("solve_bucketed", "run_lp_directory", "run_problems",
                    "cli.main", "Model.optimize", "autotune")


def _campaign_entry(entry):
    from onephase_tpu_torch import cli, harness
    from onephase_tpu_torch.autotune import autotune
    from onephase_tpu_torch.model import Model
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.models.lp import LPData
    from onephase_tpu_torch.parallel.buckets import solve_bucketed
    lp = LPData(cvec=np.ones(2), A=np.ones((1, 2)), lcon=np.zeros(1),
                ucon=np.ones(1), lvar=np.zeros(2), uvar=np.ones(2))
    model = Model()
    x = model.add_variable(lb=0.0)
    model.add_linear_constraint({x: 1.0}, lb=1.0)
    model.set_objective({x: 1.0})
    root = "/nonexistent/campaign"
    return {
        "solve_bucketed": lambda: solve_bucketed({"lp": lp}),
        "run_lp_directory": lambda: harness.run_lp_directory(
            root, "t", out_root=root),
        "run_problems": lambda: harness.run_problems(
            {"lp1": zoo.toy_lp1()}, "t", out_root=root),
        "cli.main": lambda: cli.main(["--problem-set", "zoo",
                                      "--output-dir", root]),
        "Model.optimize": model.optimize,
        "autotune": lambda: autotune(zoo.circle_nc1()),
    }[entry]


@pytest.mark.parametrize("entry", [
    "canonicalize", "one_phase_solve", "make_qp", "chain_ocp",
    "ChainKernel", "BandedKernel", "ScenarioKernel", "state_from_numpy",
    "lp_spec", *MODEL_FNS, *CAMPAIGN_ENTRIES])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a device and without a card every entry point raises and
    says how to ask for the CPU; it never carries on quietly there."""
    call = _entry_call(entry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


# numpy pieces the port copies from the JAX package unchanged:
# (JAX module, port module, names)
COPIED = (
    ("onephase_tpu.models.lp", "onephase_tpu_torch.models.lp",
     ("write_mps", "read_mps_data")),
    ("onephase_tpu.models.netlib", "onephase_tpu_torch.models.netlib",
     ("_rng", "_lp_base", "_lpi_instance", "sized_mixed_suite")),
    ("onephase_tpu.parallel.buckets", "onephase_tpu_torch.parallel.buckets",
     ("_round_up", "_Instance", "BucketResult", "eliminate_fixed",
      "_finite", "equilibrate_rows", "pad_lp", "bucket_shapes")),
)


@pytest.mark.parametrize("jmod, tmod, names", COPIED,
                         ids=[c[1].rsplit(".", 1)[1] for c in COPIED])
def test_copied_numpy_pieces_equal(jmod, tmod, names):
    """Each copied function or class has the JAX package's source, line
    for line; the copied constants are equal."""
    import inspect
    j, t = importlib.import_module(jmod), importlib.import_module(tmod)
    for name in names:
        assert inspect.getsource(getattr(t, name)) == \
            inspect.getsource(getattr(j, name)), name
    for const in ("INF", "BIG", "LPI_DIMS", "_MECHANISMS"):
        if hasattr(j, const):
            assert getattr(t, const) == getattr(j, const), const
