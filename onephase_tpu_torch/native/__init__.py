"""Host-side structure analysis: a C++ library built at first use, with a
numpy route where no compiler exists.

The port's own copy of onephase_tpu/native/ (it imports nothing of that
package and never loads its `_structure.so`).  This is symbolic analysis on
the host -- the role SuiteSparse/MA97 orderings and clever_symmetric.jl's
parallel-row machinery play for the reference -- not a device kernel:

- `rcm_order`: reverse Cuthill-McKee ordering of a symmetric pattern, run
  once per `BandedKernel` (parallel/banded.py);
- `detect_parallel_rows`: groups of Jacobian rows that are scalar multiples
  of one another.

`structure.cpp` is compiled with g++ into `onephase_tpu_torch/build/` (never
into the package directory); the library's name carries a hash of the
source.  The two routes order ties differently (the C++ sort is not stable
across equal degrees), so code that compares permutations must run both
sides on the same route: `route()` says which one is in use.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "structure.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_lib = None
_tried = False


def _so_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libonephase_structure_{tag}.so"


def _build(so: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp)], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded C++ library, built first if needed; None where it cannot
    be built or loaded (the numpy route then takes over)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.detect_parallel_rows.restype = ctypes.c_int64
    lib.detect_parallel_rows.argtypes = [
        ctypes.c_int64, i64p, i64p, f64p, ctypes.c_double, i64p, f64p]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    _lib = lib
    return _lib


def route() -> str:
    """"native" when the C++ library is in use, else "numpy"."""
    return "native" if get_lib() is not None else "numpy"


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_csr(dense: np.ndarray, tol: float = 0.0):
    """CSR (indptr, indices, data) of the entries with |value| > tol, rows
    in order and columns ascending within a row."""
    m = dense.shape[0]
    mask = dense if dense.dtype == np.bool_ and tol == 0.0 \
        else np.abs(dense) > tol
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    data = dense[rows, cols].astype(np.float64)
    return indptr, cols.astype(np.int64), data


def detect_parallel_rows(J: np.ndarray, tol: float = 1e-12
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Group rows of J that are scalar multiples of each other.

    Returns (group_id[m], the root row index of each row's group; ratio[m]
    with row = ratio * root; the count of groups of two or more rows)."""
    J = np.ascontiguousarray(np.asarray(J, dtype=np.float64))
    m = J.shape[0]
    group = np.arange(m, dtype=np.int64)
    ratio = np.ones(m)
    if m == 0:
        return group, ratio, 0
    lib = get_lib()
    indptr, indices, data = _as_csr(J)
    if lib is not None:
        ng = lib.detect_parallel_rows(
            m, _i64(indptr), _i64(indices),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), tol,
            _i64(group),
            ratio.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return group, ratio, int(ng)
    # numpy route: normalize rows by their leading nonzero, hash patterns
    ng = 0
    seen = {}
    for i in range(m):
        s, e = indptr[i], indptr[i + 1]
        if e == s:
            continue
        lead = data[s]
        key = (tuple(indices[s:e].tolist()),
               tuple(np.round(data[s:e] / lead, 9).tolist()))
        if key in seen:
            root = seen[key]
            group[i] = root
            ratio[i] = data[s] / data[indptr[root]]
            if (group == root).sum() == 2:
                ng += 1
        else:
            seen[key] = i
    return group, ratio, ng


def rcm_order(pattern: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a symmetric sparsity pattern
    (n, n), bool or numeric; returns the permutation (n,) int64."""
    A = np.asarray(pattern)
    if A.dtype != np.bool_:
        A = np.abs(A) > 0
    A = A | A.T
    n = A.shape[0]
    lib = get_lib()
    if lib is not None:
        indptr, indices, _ = _as_csr(A)
        perm = np.zeros(n, dtype=np.int64)
        lib.rcm_order(n, _i64(indptr), _i64(indices), _i64(perm))
        return perm
    # numpy route: breadth-first search from a minimum-degree seed
    deg = A.sum(1)
    visited = np.zeros(n, bool)
    out = []
    while not visited.all():
        seed = int(np.argmin(np.where(visited, np.iinfo(np.int32).max, deg)))
        q = collections.deque([seed])
        visited[seed] = True
        while q:
            u = q.popleft()
            out.append(u)
            nbrs = [v for v in np.nonzero(A[u])[0] if not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                visited[v] = True
                q.append(v)
    return np.asarray(out[::-1], dtype=np.int64)
