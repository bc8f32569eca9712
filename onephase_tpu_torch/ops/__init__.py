"""Kernel library of the port: hand-written CUDA C++ kernels for Hopper
(`csrc/`, built by `_build`) beside their plain PyTorch versions.

A kernel wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each wrapper adds one to its
entry of `LAUNCHES` where it launches its kernel, and nowhere else, so a run
can show that the main path went through the kernels.
"""

LAUNCHES = {"fused_q": 0, "chol": 0, "tri_inv_gram": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts():
    return dict(LAUNCHES)
