// K2: the batched small dense inverse (Gauss-Jordan), on Hopper.
//
// Replaces firedrake_tpu/ops/batched_inverse.py::_pallas_batched_inv
// (body _gj_kernel), which inverts blocks of 256 n x n matrices per grid
// step, the batch in lanes, by Gauss-Jordan without pivoting.  This kernel
// computes the same inverse of each matrix of a (nb, n, n) batch, for any
// nb and 1 <= n <= 32, in float32 or float64.  Its callers are the
// vertex-star patch smoothers (solvers/preconditioners.py), with n = 7
// (P1 triangles), 15 (P1 Kuhn tets) and 19 (P2 triangles).
//
// What bounds it: bytes on paper, shared memory in this design.  Each
// matrix is read once and its inverse written once (2 n^2 values), while
// the elimination does about 4 n^3 flops: 19 x 19 in float64 moves 5.8 kB
// for 27 kflop.  Design: one warp per matrix.  The warp stages [A | I]
// (n rows of 2n values) in shared memory with coalesced loads; each lane
// owns the columns lane and lane + 32 of it.  Step k copies column k into
// a small buffer, then every lane scales the pivot row entries of its
// columns by 1 / A[k][k] and eliminates them from every other row, with a
// __syncwarp() between the copy and the update and after the update; the
// warp needs no block-level barrier.  The right half is written back
// coalesced.  The sequential dependence between pivot steps stays inside
// the warp; the batch spreads over warps and SMs.
//
// Rounding: the products and differences use the _rn intrinsics, so nvcc
// contracts nothing into an FMA and each value is rounded as in the plain
// PyTorch version (ops/batched_inverse.py: batched_inv_plain), the same
// order of operations as _gj_kernel.
//
// Interface: plain C, called through ctypes.  The launch goes on the
// caller's stream and is not synchronised; the return value is
// cudaGetLastError() after the launch, or a negative code for arguments
// the kernel does not take.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxN = 32;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    gj_inverse_kernel(const T* __restrict__ a, T* __restrict__ out,
                      long long nb, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w2 = 2 * n;
  T* M = reinterpret_cast<T*>(smem_raw) + (size_t)warp * (n * w2 + n);
  T* col = M + n * w2;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= nb) return;  // the whole warp leaves together
  const T* src = a + p * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    M[i * w2 + j] = src[e];
    M[i * w2 + n + j] = (i == j) ? T(1) : T(0);
  }
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    if (lane < n) col[lane] = M[lane * w2 + k];
    __syncwarp();
    const T inv_piv = T(1) / col[k];
    for (int c = lane; c < w2; c += 32) {
      const T r = mul_rn(M[k * w2 + c], inv_piv);
      for (int i = 0; i < n; ++i)
        M[i * w2 + c] =
            (i == k) ? r : sub_rn(M[i * w2 + c], mul_rn(col[i], r));
    }
    __syncwarp();
  }
  T* dst = out + p * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    dst[e] = M[i * w2 + n + j];
  }
}

template <typename T>
int launch(const void* a, void* out, long long nb, int n,
           cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (n * 2 * n + n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (nb + kWarps - 1) / kWarps;
  gj_inverse_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), nb, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fdt_batched_inv(int is_double, const void* a, void* out,
                               long long nb, int n, void* stream) {
  if (nb <= 0 || n < 1 || n > kMaxN ||
      (nb + kWarps - 1) / kWarps > 2147483647LL)
    return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(a, out, nb, n, s)
                   : launch<float>(a, out, nb, n, s);
}
