// Host-side sparse-structure analysis for the one-phase IPM runtime.
//
// Native (C++) equivalent of the reference's symbolic machinery:
//  - parallel-row group detection (clever_symmetric.jl:106-269:
//    sorted_col_list / compare_columns / breakpoints / compute_indicies):
//    find groups of Jacobian rows that are scalar multiples of one another,
//    so the KKT system can merge their barrier diagonals harmonically and
//    factor a reduced system.
//  - reverse Cuthill-McKee ordering for bandwidth reduction of the
//    factorization target (stands in for the orderings CHOLMOD/MA97 run
//    natively in the reference's backends, julia.jl/hsl.jl).
//
// Exposed with a plain C ABI for ctypes; compiled at first use by
// onephase_tpu_torch/native/__init__.py.  The port's own copy of
// onephase_tpu/native/structure.cpp (same algorithms, same tie-breaking).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <numeric>
#include <vector>

extern "C" {

// Detect groups of parallel rows of an m x n CSR matrix.
// Inputs: indptr[m+1], indices[nnz], data[nnz], tol (relative).
// Outputs: group_id[m] (root row index of each row's group; singleton rows
// get their own id), ratio[m] (row = ratio * root_row).
// Returns the number of nontrivial groups (size >= 2).
int64_t detect_parallel_rows(int64_t m, const int64_t* indptr,
                             const int64_t* indices, const double* data,
                             double tol, int64_t* group_id, double* ratio) {
    std::vector<int64_t> order(m);
    std::iota(order.begin(), order.end(), 0);

    // sort rows by (sparsity pattern, then normalized values) so parallel
    // rows become adjacent — the reference's sorted_col_list/compare_columns
    auto row_less = [&](int64_t a, int64_t b) {
        int64_t sa = indptr[a], ea = indptr[a + 1];
        int64_t sb = indptr[b], eb = indptr[b + 1];
        int64_t la = ea - sa, lb = eb - sb;
        if (la != lb) return la < lb;
        for (int64_t k = 0; k < la; ++k) {
            if (indices[sa + k] != indices[sb + k])
                return indices[sa + k] < indices[sb + k];
        }
        if (la == 0) return false;
        // identical pattern: compare values scaled by leading entry
        double fa = data[sa], fb = data[sb];
        if (fa == 0.0 || fb == 0.0) return fa < fb;
        for (int64_t k = 0; k < la; ++k) {
            double va = data[sa + k] / fa, vb = data[sb + k] / fb;
            double diff = va - vb;
            double mag = std::max(std::abs(va), std::abs(vb));
            if (std::abs(diff) > tol * std::max(1.0, mag))
                return va < vb;
        }
        return false;
    };
    std::stable_sort(order.begin(), order.end(), row_less);

    auto rows_parallel = [&](int64_t a, int64_t b, double* r_out) {
        int64_t sa = indptr[a], ea = indptr[a + 1];
        int64_t sb = indptr[b], eb = indptr[b + 1];
        if (ea - sa != eb - sb || ea == sa) return false;
        for (int64_t k = 0; k < ea - sa; ++k)
            if (indices[sa + k] != indices[sb + k]) return false;
        if (data[sa] == 0.0) return false;
        double r = data[sb] / data[sa];
        for (int64_t k = 0; k < ea - sa; ++k) {
            double want = data[sa + k] * r;
            double got = data[sb + k];
            double mag = std::max(std::abs(want), std::abs(got));
            if (std::abs(want - got) > tol * std::max(1.0, mag)) return false;
        }
        *r_out = r;
        return true;
    };

    for (int64_t i = 0; i < m; ++i) { group_id[i] = i; ratio[i] = 1.0; }
    int64_t ngroups = 0;
    int64_t i = 0;
    while (i < m) {
        int64_t root = order[i];
        int64_t j = i + 1;
        bool grew = false;
        while (j < m) {
            double r;
            if (!rows_parallel(root, order[j], &r)) break;
            group_id[order[j]] = root;
            ratio[order[j]] = r;
            grew = true;
            ++j;
        }
        if (grew) ++ngroups;
        i = j;
    }
    return ngroups;
}

// Reverse Cuthill-McKee ordering of a symmetric sparsity pattern (n x n,
// CSR upper+lower).  perm[n] receives the new ordering.
void rcm_order(int64_t n, const int64_t* indptr, const int64_t* indices,
               int64_t* perm) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int64_t> result;
    result.reserve(n);
    std::vector<int64_t> queue;

    for (;;) {
        // pick unvisited vertex of minimum degree as the next component seed
        int64_t seed = -1, best = INT64_MAX;
        for (int64_t i = 0; i < n; ++i)
            if (!visited[i] && degree[i] < best) { best = degree[i]; seed = i; }
        if (seed < 0) break;
        queue.clear();
        queue.push_back(seed);
        visited[seed] = 1;
        for (size_t qh = 0; qh < queue.size(); ++qh) {
            int64_t u = queue[qh];
            result.push_back(u);
            std::vector<int64_t> nbrs;
            for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
                int64_t v = indices[k];
                if (v >= 0 && v < n && !visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
                return degree[a] < degree[b];
            });
            for (int64_t v : nbrs) queue.push_back(v);
        }
    }
    // reverse
    for (int64_t i = 0; i < n; ++i) perm[i] = result[n - 1 - i];
}

}  // extern "C"
