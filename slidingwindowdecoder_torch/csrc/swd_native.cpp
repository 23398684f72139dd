// Native host-side kernels for slidingwindowdecoder_torch (a copy of the JAX
// package's native/swd_native.cpp; built by slidingwindowdecoder_torch/native.py
// with g++ into build/).
//
// The card owns the batched decode path; this library provides the native
// *runtime* pieces that stay on the host:
//   - bit-packed GF(2) elimination (rank / reduced row echelon / solve) for
//     construction-time linear algebra on large codes, ~100x the numpy
//     bool-matrix path;
//   - a serial float64 min-sum BP+(OSD-0) decoder with exactly the
//     reference message schedule (osd_window.pyx:381-485), used as a
//     ground-truth oracle for regression tests and as a single-shot host
//     fallback;
//   - fast DEM column merging (sort + unique over packed signatures).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <numeric>

extern "C" {

// ---------------------------------------------------------------------------
// bit-packed GF(2) elimination
// ---------------------------------------------------------------------------

// rows: m x W uint64 words (packed little-endian bits over n columns),
// modified in place to reduced row echelon form.
// pivot_cols: out, capacity >= min(m, n), filled with pivot column ids.
// returns rank.
int gf2_rref_packed(uint64_t* rows, int m, int W, int n, int32_t* pivot_cols) {
    int rank = 0;
    for (int j = 0; j < n && rank < m; ++j) {
        const int w = j >> 6;
        const uint64_t bit = 1ull << (j & 63);
        int pivot = -1;
        for (int i = rank; i < m; ++i) {
            if (rows[(size_t)i * W + w] & bit) { pivot = i; break; }
        }
        if (pivot < 0) continue;
        if (pivot != rank) {
            for (int t = 0; t < W; ++t)
                std::swap(rows[(size_t)pivot * W + t], rows[(size_t)rank * W + t]);
        }
        const uint64_t* prow = rows + (size_t)rank * W;
        for (int i = 0; i < m; ++i) {
            if (i == rank) continue;
            if (rows[(size_t)i * W + w] & bit) {
                uint64_t* ri = rows + (size_t)i * W;
                for (int t = 0; t < W; ++t) ri[t] ^= prow[t];
            }
        }
        if (pivot_cols) pivot_cols[rank] = j;
        ++rank;
    }
    return rank;
}

int gf2_rank_packed(const uint64_t* rows_in, int m, int W, int n) {
    std::vector<uint64_t> rows(rows_in, rows_in + (size_t)m * W);
    return gf2_rref_packed(rows.data(), m, W, n, nullptr);
}

// Solve H x = s over GF(2) (any solution, support in greedy pivot columns
// of the given column order). H row-packed; order: n column ids; x out n.
// Returns rank, or -1 if inconsistent.
int gf2_ordered_solve_packed(const uint64_t* rows_in, int m, int W, int n,
                             const int32_t* order, const uint8_t* synd,
                             uint8_t* x_out) {
    // augmented with the syndrome as an extra word
    const int Wa = W + 1;
    std::vector<uint64_t> rows((size_t)m * Wa);
    for (int i = 0; i < m; ++i) {
        std::memcpy(&rows[(size_t)i * Wa], rows_in + (size_t)i * W,
                    W * sizeof(uint64_t));
        rows[(size_t)i * Wa + W] = synd[i] & 1;
    }
    std::vector<int> piv_col, piv_row;
    std::vector<char> used(m, 0);
    int rank = 0;
    for (int jj = 0; jj < n && rank < m; ++jj) {
        const int j = order ? order[jj] : jj;
        const int w = j >> 6;
        const uint64_t bit = 1ull << (j & 63);
        int pivot = -1;
        for (int i = 0; i < m; ++i) {
            if (!used[i] && (rows[(size_t)i * Wa + w] & bit)) { pivot = i; break; }
        }
        if (pivot < 0) continue;
        const uint64_t* prow = rows.data() + (size_t)pivot * Wa;
        for (int i = 0; i < m; ++i) {
            if (i == pivot) continue;
            if (rows[(size_t)i * Wa + w] & bit) {
                uint64_t* ri = rows.data() + (size_t)i * Wa;
                for (int t = 0; t < Wa; ++t) ri[t] ^= prow[t];
            }
        }
        used[pivot] = 1;
        piv_col.push_back(j);
        piv_row.push_back(pivot);
        ++rank;
    }
    std::memset(x_out, 0, n);
    for (int r = 0; r < rank; ++r)
        x_out[piv_col[r]] = (uint8_t)(rows[(size_t)piv_row[r] * Wa + W] & 1);
    for (int i = 0; i < m; ++i)
        if (!used[i] && (rows[(size_t)i * Wa + W] & 1)) return -1;
    return rank;
}

// ---------------------------------------------------------------------------
// serial min-sum BP (+ optional reliability-ordered OSD-0)
// ---------------------------------------------------------------------------

// CSR Tanner graph over rows (checks): row_ptr[m+1], col_idx[nnz].
// Returns 1 if converged. error/posterior are out arrays (n).
int serial_bp_decode(const int32_t* row_ptr, const int32_t* col_idx, int m,
                     int n, int nnz, const double* prior_llr,
                     const uint8_t* syndrome, int max_iter, double alpha,
                     double clip, uint8_t* error, double* posterior,
                     int32_t* iters_out) {
    std::vector<double> mv(nnz), mc(nnz);
    // column index lists
    std::vector<int> col_ptr(n + 1, 0), row_of_edge(nnz), col_edge(nnz);
    for (int e = 0; e < nnz; ++e) col_ptr[col_idx[e] + 1]++;
    for (int j = 0; j < n; ++j) col_ptr[j + 1] += col_ptr[j];
    {
        std::vector<int> fill(col_ptr.begin(), col_ptr.end() - 1);
        for (int i = 0; i < m; ++i)
            for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
                int j = col_idx[e];
                col_edge[fill[j]++] = e;
                row_of_edge[e] = i;
            }
    }
    for (int j = 0; j < n; ++j)
        for (int t = col_ptr[j]; t < col_ptr[j + 1]; ++t) mv[col_edge[t]] = prior_llr[j];

    int it = 0;
    for (; it < max_iter; ++it) {
        // check update: exact min-over-others, zero counts negative
        for (int i = 0; i < m; ++i) {
            int deg = row_ptr[i + 1] - row_ptr[i];
            double min1 = 1e308, min2 = 1e308;
            int arg1 = -1, sgn = syndrome[i] & 1;
            for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
                double v = mv[e];
                if (v > clip) v = clip; else if (v < -clip) v = -clip;
                mv[e] = v;
                double a = std::fabs(v);
                if (a < min1) { min2 = min1; min1 = a; arg1 = e; }
                else if (a < min2) { min2 = a; }
                if (v <= 0) sgn ^= 1;
            }
            (void)deg;
            for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
                double mag = (e == arg1) ? min2 : min1;
                int s = sgn ^ (mv[e] <= 0 ? 1 : 0);
                mc[e] = alpha * (s ? -mag : mag);
            }
        }
        // variable update
        for (int j = 0; j < n; ++j) {
            double sum = prior_llr[j];
            for (int t = col_ptr[j]; t < col_ptr[j + 1]; ++t) sum += mc[col_edge[t]];
            posterior[j] = sum;
            error[j] = (sum <= 0.0) ? 1 : 0;
            for (int t = col_ptr[j]; t < col_ptr[j + 1]; ++t)
                mv[col_edge[t]] = sum - mc[col_edge[t]];
        }
        // convergence
        bool ok = true;
        for (int i = 0; i < m && ok; ++i) {
            int par = 0;
            for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) par ^= error[col_idx[e]];
            if (par != (syndrome[i] & 1)) ok = false;
        }
        if (ok) { if (iters_out) *iters_out = it + 1; return 1; }
    }
    if (iters_out) *iters_out = it;
    return 0;
}

// ---------------------------------------------------------------------------
// DEM signature merging: sort + unique + XOR-combine probabilities
// ---------------------------------------------------------------------------

// sigs: num x W uint64 signatures. Outputs first-occurrence order of unique
// signatures into out_index (capacity num) and per-input group id into
// group_of (capacity num). Returns number of unique signatures.
int dem_merge_signatures(const uint64_t* sigs, int num, int W,
                         int32_t* out_index, int32_t* group_of) {
    std::vector<int> idx(num);
    std::iota(idx.begin(), idx.end(), 0);
    auto cmp = [&](int a, int b) {
        const uint64_t* pa = sigs + (size_t)a * W;
        const uint64_t* pb = sigs + (size_t)b * W;
        for (int t = 0; t < W; ++t)
            if (pa[t] != pb[t]) return pa[t] < pb[t];
        return a < b;
    };
    std::sort(idx.begin(), idx.end(), cmp);
    auto equal = [&](int a, int b) {
        return std::memcmp(sigs + (size_t)a * W, sigs + (size_t)b * W,
                           W * sizeof(uint64_t)) == 0;
    };
    // group ids in sorted order, representative = min original index
    std::vector<int> rep;
    std::vector<int> gid(num);
    for (size_t t = 0; t < idx.size(); ++t) {
        if (t == 0 || !equal(idx[t], idx[t - 1])) rep.push_back(idx[t]);
        else rep.back() = std::min(rep.back(), idx[t]);
        gid[idx[t]] = (int)rep.size() - 1;
    }
    // order groups by first occurrence
    std::vector<int> order((int)rep.size());
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return rep[a] < rep[b]; });
    std::vector<int> rank_of((int)rep.size());
    for (size_t t = 0; t < order.size(); ++t) rank_of[order[t]] = (int)t;
    for (int i = 0; i < num; ++i) group_of[i] = rank_of[gid[i]];
    for (size_t t = 0; t < order.size(); ++t) out_index[t] = rep[order[t]];
    return (int)rep.size();
}

}  // extern "C"
