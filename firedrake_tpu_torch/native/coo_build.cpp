// Native sparsity construction kernel (the port's copy of
// firedrake_tpu/native/coo_build.cpp).
//
// Reference: pyop2/sparsity.pyx:105 build_sparsity (Cython/C over PETSc
// preallocator).  Role here: the hot host-side step of Sparsity — sort
// the per-entity (row, col) keys, unique them, and emit the per-entry
// scatter position — done in C++ (std::stable_sort over an index
// permutation) instead of np.unique, which dominates mesh preprocessing
// at 1M+ cells.
//
// The sort is stable (ties keep their input order), so the sort order it
// returns equals numpy's argsort(keys, kind="stable"): the assembler
// builds its accumulation tables from it instead of sorting the keys
// again.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// keys: n int64 entity keys (row*ncols + col), key < 0 = sentinel.
// out_positions: n int32 (position of each key among the uniques;
//                sentinel keys get nnz).
// out_uniq: capacity-n int64 buffer; returns nnz (number of uniques).
// out_order: n int64, the stable sort order of keys (sentinels first).
int64_t coo_sort_unique(const int64_t* keys, int64_t n,
                        int32_t* out_positions, int64_t* out_uniq,
                        int64_t* out_order) {
    int64_t* order = out_order;
    std::iota(order, order + n, 0);
    std::stable_sort(order, order + n, [keys](int64_t a, int64_t b) {
        return keys[a] < keys[b];
    });
    // walk the sorted permutation, assigning unique slots
    int64_t nnz = 0;
    int64_t prev = INT64_MIN;
    std::vector<int32_t> pos_of_sorted(n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t k = keys[order[i]];
        if (k < 0) {                 // sentinel (restricted dof)
            pos_of_sorted[i] = -1;
            continue;
        }
        if (k != prev) {
            out_uniq[nnz] = k;
            prev = k;
            ++nnz;
        }
        pos_of_sorted[i] = static_cast<int32_t>(nnz - 1);
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t p = pos_of_sorted[i];
        out_positions[order[i]] =
            (p < 0) ? static_cast<int32_t>(nnz) : p;
    }
    return nnz;
}

}  // extern "C"
