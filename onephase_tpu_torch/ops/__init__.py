"""Kernel library of the port: hand-written CUDA C++ kernels for Hopper
(`csrc/`, built by `_build`) beside their plain PyTorch versions.

A kernel wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each wrapper adds one to its
entry of `LAUNCHES` where it launches its kernel, and nowhere else, so a run
can show that the main path went through the kernels.  The wrappers of
K1-K3, K5 and K7 also tally each launch under its matmul mode
(ops/precision.py) in `LAUNCH_MODES`, {kernel: {mode: launches}}, so a run
can show that the mode reached the kernel.
"""

LAUNCHES = {"fused_q": 0, "fused_q_tri": 0, "chol": 0, "tri_inv_gram": 0,
            "tridiag_factor": 0, "tridiag_solve": 0}
LAUNCH_MODES = {}


def count_launch(kernel, mode):
    """One launch of `kernel` in matmul mode `mode`."""
    LAUNCHES[kernel] += 1
    tally = LAUNCH_MODES.setdefault(kernel, {})
    tally[str(mode)] = tally.get(str(mode), 0) + 1


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_MODES.clear()


def launch_counts():
    return dict(LAUNCHES)


def launch_modes():
    return {k: dict(v) for k, v in LAUNCH_MODES.items()}
