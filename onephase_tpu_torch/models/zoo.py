"""Analytic test problems: torch twins of onephase_tpu/models/zoo.py
(the reference's test/problems.jl) used by the parity tests, plus HS071.

The functions are written for one instance (1-D z) with Python-float
constants only, so they compute in whatever dtype z has.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLPSpec

INF = np.inf


def rosenbrook1():
    # unconstrained — must be rejected (reference: one_phase.jl:25-27)
    return NLPSpec(
        f=lambda z: (2.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2,
        x0=[0.0, 0.0], name="rosenbrook1")


def rosenbrook2():
    return NLPSpec(
        f=lambda z: (2.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2,
        c=lambda z: torch.stack([z[0] + z[1], z[0] * z[1] + z[0]]),
        lcon=[0.1, 0.1], ucon=[INF, INF],
        lvar=[0.0, 0.0], uvar=[INF, INF],
        x0=[0.0, 0.0], lin=(0,), name="rosenbrook2")


def toy_lp0():
    return NLPSpec(
        f=lambda z: z[0],
        c=lambda z: torch.stack([z[0]]),
        lcon=[4.0], ucon=[INF],
        x0=[0.0], name="toy_lp0")


def toy_lp1():
    return NLPSpec(
        f=lambda z: -z[0] - 100.0 * z[1],
        c=lambda z: torch.stack([z[0] + z[1]]),
        lcon=[-INF], ucon=[1.0],
        lvar=[0.0, 0.0], uvar=[INF, INF],
        x0=[0.0, 0.0], lin=(0,), name="toy_lp1")


def toy_lp_inf1():
    return NLPSpec(
        f=lambda z: z[0] + 100.0 * z[1],
        c=lambda z: torch.stack([z[0] + 2.0 * z[1]]),
        lcon=[-INF], ucon=[-1.0],
        lvar=[0.0, 0.0], uvar=[INF, INF],
        x0=[0.0, 0.0], lin=(0,), name="toy_lp_inf1")


def circle1():
    return NLPSpec(
        f=lambda z: z[0] + 100.0 * z[1],
        c=lambda z: torch.stack([z[0] ** 2 + z[1] ** 2,
                                 (z[0] - 2.0) ** 2 + z[1] ** 2]),
        lcon=[-INF, -INF], ucon=[1.0, 1.0],
        lvar=[0.0, 0.0], uvar=[INF, INF],
        x0=[0.0, 0.0], name="circle1")


def quad_opt():
    return NLPSpec(
        f=lambda z: z[1],
        c=lambda z: torch.stack([z[1] - z[0] ** 2]),
        lcon=[0.0], ucon=[INF],
        x0=[0.0, 0.0], name="quad_opt")


def circle_nc1():
    return NLPSpec(
        f=lambda z: z[0] + 100.0 * z[1],
        c=lambda z: torch.stack([z[0] ** 2 + z[1] ** 2,
                                 (z[0] - 2.0) ** 2 + z[1] ** 2]),
        lcon=[1.0, 1.0], ucon=[1.0, 1.0],
        lvar=[0.0, 0.0], uvar=[INF, INF],
        x0=[0.0, 0.0], name="circle_nc1")


def lp_unbd():
    return NLPSpec(
        f=lambda z: -z[0],
        c=lambda z: torch.stack([z[0] - z[1]]),
        lcon=[-INF], ucon=[1.0],
        lvar=[0.0, -INF], uvar=[INF, INF],
        x0=[0.0, 0.0], lin=(0,), name="lp_unbd")


def quad_unbd():
    return NLPSpec(
        f=lambda z: z[0],
        c=lambda z: torch.stack([z[1] - z[0] ** 2]),
        lcon=[0.0], ucon=[INF],
        x0=[0.0, 0.0], name="quad_unbd")


def unbd_feas():
    return NLPSpec(
        f=lambda z: z[1],
        c=lambda z: torch.stack([z[1] - z[0] ** 2, z[2]]),
        lcon=[0.0, 0.0], ucon=[INF, INF],
        lvar=[0.0, 0.0, 0.0], uvar=[INF, INF, INF],
        x0=[0.0, 0.0, 0.0], name="unbd_feas")


def hs071():
    """Hock-Schittkowski 71 (README quick start): Optimal, obj 17.0140173."""
    return NLPSpec(
        f=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        c=lambda x: torch.stack([x[0] * x[1] * x[2] * x[3],
                                 x[0] ** 2 + x[1] ** 2 + x[2] ** 2
                                 + x[3] ** 2]),
        lcon=[25.0, 40.0], ucon=[INF, 40.0],
        lvar=[1.0] * 4, uvar=[5.0] * 4, x0=[1.0, 5.0, 5.0, 1.0],
        name="hs071")
