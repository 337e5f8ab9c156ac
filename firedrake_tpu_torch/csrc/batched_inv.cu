// K2: the batched small dense inverse (Gauss-Jordan), on Hopper.
//
// Replaces firedrake_tpu/ops/batched_inverse.py::_pallas_batched_inv
// (body _gj_kernel), which inverts blocks of 256 n x n matrices per grid
// step, the batch in lanes, by Gauss-Jordan without pivoting.  This kernel
// computes the same inverse of each matrix of a (nb, n, n) batch, for any
// nb and 1 <= n <= 32, in float32 or float64; a second variant takes
// 33 <= n <= 128 and a third, at the end of the file, any n above it.
// Each variant also has a pivoted mode (partial pivoting, below).  Its
// callers are the
// vertex-star patch smoothers (solvers/preconditioners.py), with n = 7
// (P1 triangles), 15 (P1 Kuhn tets) and 19 (P2 triangles).
//
// What bounds it: bytes on paper (each matrix read once and its inverse
// written once, 2 n^2 values, against 2 n^3 multiplies and subtractions),
// and in practice the latency of the n dependent pivot steps of each
// matrix.  The design attacks the latency:
//
// * In place on n x n.  After pivot step k, column k of the eliminated
//   matrix is a unit column and column k of the inverse is the only new
//   column, so the inverse's column k is stored where A's was.  The
//   operations this skips are exact in IEEE arithmetic (x * 0, 0 - p,
//   1 * r), so every stored value is rounded exactly as in the plain
//   version on [A | I] (ops/batched_inverse.py: batched_inv_plain),
//   signed zeros aside.
// * Registers.  One lane holds one row of one matrix; floor(32 / n)
//   matrices share a warp (4 at n = 7, 2 at n = 15, 1 at n = 19).  A row
//   lives in NB registers, n rounded up to a multiple of 4 (eight
//   template buckets).  Registers cannot be indexed at run time, so the
//   row rotates: at step k column j sits at position (j - k) mod NB, the
//   pivot column at a position fixed at compile time.  The steps run as a
//   loop over groups of four unrolled steps with one rotation per group;
//   unrolling all NB steps instead (the first version of this design)
//   made a body of ~4k instructions at NB = 32 and took 2.19 ms where
//   this takes 1.23 ms (chip_smoke.py on an H100, float64, n = 19), most
//   likely because the instruction cache refilled on every matrix.  At step k the lane
//   holding row k scales it and writes it to a small per-matrix buffer in
//   shared memory (two buffers, alternating, so one __syncwarp() per step
//   orders writer and readers); the other lanes read it back as 16-byte
//   vectors and update their rows.  A shuffle moves 4 bytes, so a double
//   row broadcast by shuffles would cost two per value, more issue slots
//   than the arithmetic it feeds.
// * Loads that overlap the elimination.  A persistent grid (as many
//   blocks as fit on the SMs) walks the batch in chunks of one matrix
//   group per warp.  Each block copies the next chunk into shared memory
//   with cp.async while it eliminates the current one (two buffers), and
//   each warp writes its results back through shared memory, coalesced.
//
// Rounding: the products and differences use the _rn intrinsics, so nvcc
// contracts nothing into an FMA, and 1 / pivot is the correctly rounded
// reciprocal; the result equals the plain version bit for bit.  An FMA
// in the update gives other roundings for less than 10% less time
// (scripts/torch_k2_fma.py), too little to give up exact agreement.
//
// What bounds it now: issue slots and the latency of the pivot steps.
// In float64 at n = 19 each step costs a warp ~2n f64 operations for
// 19 busy lanes of 32, about 0.36 ms of the f64 pipe for the batch
// against 0.45 ms of bytes; the rest is the serial pivot-lane work
// (reciprocal, scaling, the write) that the other lanes wait for.
//
// Partial pivoting (the `pivot` flag of every variant): at step k the
// pivot row is the first i >= k with the largest |M[i, k]| (the tie rule
// of torch.argmax), rows k and i of [M | X] are swapped, then the step
// eliminates as without pivoting.  In place, column k then holds the
// inverse's column L_k, L_k being the original index of the row swapped
// into position k; each variant carries these labels with the rows and
// writes column k to column L_k at the end.  A swap moves values without
// rounding, so the pivoted mode too equals its plain version
// (ops/batched_inverse.py: batched_inv_plain(A, pivot=True)) bit for bit,
// signed zeros aside.  The unpivoted instantiations are the kernels as
// they were.
//
// Interface: plain C, called through ctypes.  The launch goes on the
// caller's stream and is not synchronised; the return value is
// cudaGetLastError() after the launch, or a negative code for arguments
// the kernel does not take.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 32;
constexpr int kGroup = 4;  // pivot steps between two register rotations

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
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float absv(float a) { return fabsf(a); }
__device__ __forceinline__ double absv(double a) { return fabs(a); }

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 16-byte moves of a pivot row between registers and shared memory.
__device__ __forceinline__ void put16(double* dst, const double* v) {
  *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void put16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void get16(double* v, const double* src) {
  const double2 x = *reinterpret_cast<const double2*>(src);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void get16(float* v, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// The pivot-row buffer of one matrix: NB values, padded so that 16-byte
// reads stay aligned and the matrices of a warp start on other banks.
template <typename T, int NB>
__host__ __device__ constexpr int pivot_stride() {
  return NB + 16 / (int)sizeof(T);
}

// Copy chunk `ch` (matrices [ch * per_chunk, ...) clipped to nb) into
// shared memory; every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ a,
                                      long long ch, int per_chunk, int nn,
                                      long long nb) {
  const long long first = ch * per_chunk;
  long long count = nb - first;
  if (count > per_chunk) count = per_chunk;
  const long long elems = count * nn;
  const T* src = a + first * nn;
  for (long long e = threadIdx.x; e < elems; e += kThreads)
    cp_async(buf + e, src + e, (int)sizeof(T));
}

// One pivot step, the pivot column at register position P: the lane
// holding the pivot row scales it by the correctly rounded 1 / pivot and
// writes it to `row`; every other lane of the matrix eliminates.  The
// padding positions (n <= p < NB) hold values that never meet a column.
template <int P, typename T, int NB>
__device__ __forceinline__ void gj_step(T (&r)[NB], T* row, bool pivot,
                                        bool other) {
  constexpr int V = 16 / (int)sizeof(T);  // values per 16-byte move
  if (pivot) {
    const T inv = rcp_rn(r[P]);
    r[P] = T(1);  // 1 * inv == inv: the inverse's entry (k, k)
#pragma unroll
    for (int p = 0; p < NB; ++p) r[p] = mul_rn(r[p], inv);
#pragma unroll
    for (int p = 0; p < NB; p += V) put16(row + p, r + p);
  }
  __syncwarp();
  if (other) {
    const T c = r[P];
    r[P] = T(0);  // 0 - c * inv: the inverse's entry (i, k)
#pragma unroll
    for (int p = 0; p < NB; p += V) {
      T x[V];
      get16(x, row + p);
#pragma unroll
      for (int v = 0; v < V; ++v)
        r[p + v] = sub_rn(r[p + v], mul_rn(c, x[v]));
    }
  }
}

// The pivoted mode's search and swap before step k, the pivot column at
// register position P: each lane of a matrix posts |M[i, k]| (rows
// i >= k) to the warp's buffer `pa`, every lane of the matrix scans the
// matrix's part for the first largest, and the lanes holding rows k and
// p exchange their rows (and row labels) by shuffles.
template <int P, typename T, int NB>
__device__ __forceinline__ void pivot_swap(T (&r)[NB], int& lbl, T* pa,
                                           int k, int i, int n, int mbase,
                                           bool active, int lane) {
  pa[lane] = (active && i >= k) ? absv(r[P]) : T(-1);
  __syncwarp();
  int best = k;
  if (active) {
    T bv = pa[mbase + k];
    for (int j = k + 1; j < n; ++j) {
      const T v = pa[mbase + j];
      if (v > bv) {
        bv = v;
        best = j;
      }
    }
  }
  __syncwarp();
  const int src = !active ? lane
                          : (i == k ? mbase + best
                                    : (i == best ? mbase + k : lane));
#pragma unroll
  for (int p = 0; p < NB; ++p) r[p] = __shfl_sync(0xffffffffu, r[p], src);
  lbl = __shfl_sync(0xffffffffu, lbl, src);
}

// Move every value U register positions down, cyclically.
template <int U, typename T, int NB>
__device__ __forceinline__ void rotate(T (&r)[NB]) {
  T t[U];
#pragma unroll
  for (int u = 0; u < U; ++u) t[u] = r[u];
#pragma unroll
  for (int p = 0; p + U < NB; ++p) r[p] = r[p + U];
#pragma unroll
  for (int u = 0; u < U; ++u) r[NB - U + u] = t[u];
}

template <typename T, int NB, bool PIV>
__global__ void __launch_bounds__(kThreads)
    gj_inverse_kernel(const T* __restrict__ a, T* __restrict__ out,
                      long long nb, int n, long long nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PS = pivot_stride<T, NB>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = 32 / n;              // matrices per warp
  const int per_chunk = kWarps * G;  // matrices per chunk
  const int nn = n * n;
  T* bufs = reinterpret_cast<T*>(smem_raw);
  T* pivots = bufs + 2 * per_chunk * nn;
  // two alternating pivot-row buffers per matrix of this warp
  T* pw = pivots + (size_t)warp * 2 * G * PS;
  const int m = lane / n, i = lane - (lane / n) * n;  // matrix, row
  const bool active = m < G;
  // pivoted mode: per warp 32 magnitudes and 32 row labels
  T* pa = pivots + (size_t)kWarps * 2 * G * PS + (size_t)warp * 64;
  T* labs = pa + 32;
  const int mbase = (active ? m : 0) * n;

  long long ch = blockIdx.x;
  stage(bufs, a, ch, per_chunk, nn, nb);
  cp_async_commit();
  stage(bufs + per_chunk * nn, a, ch + gridDim.x, per_chunk, nn, nb);
  cp_async_commit();
  for (int t = 0; ch < nchunks; ch += gridDim.x, ++t) {
    T* buf = bufs + (t & 1) * per_chunk * nn;
    cp_async_wait_one();  // this chunk's copy is done (the next may run)
    __syncthreads();

    T* mine = buf + (size_t)(warp * G + (active ? m : 0)) * nn + i * n;
    T* prow = pw + (active ? m : 0) * PS;  // + (k & 1) * G * PS at step k
    T r[NB];
#pragma unroll
    for (int p = 0; p < NB; ++p) r[p] = (active && p < n) ? mine[p] : T(0);
    int lbl = i;  // pivoted mode: the original index of the row held

    // At the start of step k, column j sits at register position
    // (j - k) mod NB: the pivot column is at a position known at compile
    // time, and the loop over steps stays a loop (a short body instead
    // of NB unrolled steps, which overflowed the instruction cache).
    int k = 0;
#pragma unroll 1
    for (; k + kGroup <= n; k += kGroup) {
      if (PIV) pivot_swap<0>(r, lbl, pa, k, i, n, mbase, active, lane);
      gj_step<0>(r, prow + (k & 1) * G * PS, active && i == k,
                 active && i != k);
      if (PIV) pivot_swap<1>(r, lbl, pa, k + 1, i, n, mbase, active, lane);
      gj_step<1>(r, prow + ((k + 1) & 1) * G * PS, active && i == k + 1,
                 active && i != k + 1);
      if (PIV) pivot_swap<2>(r, lbl, pa, k + 2, i, n, mbase, active, lane);
      gj_step<2>(r, prow + (k & 1) * G * PS, active && i == k + 2,
                 active && i != k + 2);
      if (PIV) pivot_swap<3>(r, lbl, pa, k + 3, i, n, mbase, active, lane);
      gj_step<3>(r, prow + ((k + 1) & 1) * G * PS, active && i == k + 3,
                 active && i != k + 3);
      rotate<kGroup>(r);
    }
#pragma unroll 1
    for (; k < n; ++k) {
      if (PIV) pivot_swap<0>(r, lbl, pa, k, i, n, mbase, active, lane);
      gj_step<0>(r, prow + (k & 1) * G * PS, active && i == k,
                 active && i != k);
      rotate<1>(r);
    }

    // results back through this warp's part of the buffer, coalesced;
    // pivoted, column j goes to column L_j
    if (PIV) {
      labs[lane] = T(lbl);
      __syncwarp();
    }
    if (active) {
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        const int j = p + n < NB ? p + n : p + n - NB;  // (p + n) mod NB
        if (j < n) mine[PIV ? (int)labs[mbase + j] : j] = r[p];
      }
    }
    __syncwarp();
    const long long first = ch * per_chunk + warp * G;
    long long count = nb - first;
    if (count > G) count = G;
    if (count > 0) {
      const T* src = buf + (size_t)warp * G * nn;
      T* dst = out + first * nn;
      for (long long e = lane; e < count * nn; e += 32) dst[e] = src[e];
    }
    __syncthreads();  // every warp is done with this buffer
    stage(buf, a, ch + 2 * (long long)gridDim.x, per_chunk, nn, nb);
    cp_async_commit();
  }
}

template <typename T, int NB, bool PIV>
int launch(const void* a, void* out, long long nb, int n,
           cudaStream_t stream) {
  const int G = 32 / n, per_chunk = kWarps * G;
  const size_t smem =
      (2 * (size_t)per_chunk * n * n +
       (size_t)kWarps * 2 * G * pivot_stride<T, NB>() +
       (PIV ? (size_t)kWarps * 64 : 0)) *
      sizeof(T);
  auto kernel = gj_inverse_kernel<T, NB, PIV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return -4;
  const long long nchunks = (nb + per_chunk - 1) / per_chunk;
  long long blocks = (long long)sms * per_sm;
  if (blocks > nchunks) blocks = nchunks;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), nb, n, nchunks);
  return (int)cudaGetLastError();
}

// Row lengths in registers: n rounded up to a multiple of 4 (whole
// 16-byte moves in both types).
template <typename T, bool PIV>
int launch_bucket(const void* a, void* out, long long nb, int n,
                  cudaStream_t s) {
  switch ((n + 3) / 4) {
    case 1: return launch<T, 4, PIV>(a, out, nb, n, s);
    case 2: return launch<T, 8, PIV>(a, out, nb, n, s);
    case 3: return launch<T, 12, PIV>(a, out, nb, n, s);
    case 4: return launch<T, 16, PIV>(a, out, nb, n, s);
    case 5: return launch<T, 20, PIV>(a, out, nb, n, s);
    case 6: return launch<T, 24, PIV>(a, out, nb, n, s);
    case 7: return launch<T, 28, PIV>(a, out, nb, n, s);
    default: return launch<T, 32, PIV>(a, out, nb, n, s);
  }
}

// ------------------------------------------------ 33 <= n <= 128: blocks
// A row no longer fits a lane's registers, so the large variant keeps
// the matrices in shared memory, in place as above: one thread per row,
// floor(128 / n) matrices per block of 128 threads (3 at n = 40, 1 at
// n = 128; 133 KB of shared memory in float64 at n = 128).  A matrix is
// stored by columns with a padded stride n + 1, so the threads of a
// matrix, one per row, touch consecutive words when they sweep a column.
// Step k has two phases between __syncthreads(): thread i forms entry i
// of the pivot row times the correctly rounded 1 / pivot and saves entry
// i of column k; then every thread i != k updates its row with the
// pivot row (read as a broadcast) and thread k stores it.  Each product
// and difference is rounded on its own, so the result equals the plain
// version bit for bit, signed zeros aside.  What bounds it: bytes on
// paper (each matrix read and written once); in practice shared memory,
// which every step reads and writes whole (two 8-byte loads and a store
// per entry in float64, ~5 cycles of the SM's shared-memory bandwidth
// per warp and entry against ~2 of issue): 4.26 ms at (65,536, 40, 40)
// float64 on an H100 (chip_smoke.py), against a 0.50 ms byte bound.
// Grouping each thread's updates by four, loads before stores, gave 4.19
// ms in another call: not kept.  The first version of this variant, one matrix per block
// of 256 threads over its n^2 entries, spent its issue slots on index
// arithmetic and took 8.19 ms.  Rows held in registers, as in the warp
// variant, would read only the broadcast pivot row.
// Pivoted mode: a third phase before the two, in which each thread posts
// |M[i, k]| and every thread of the matrix scans them for the pivot row
// p; phase one then forms the pivot row from row p and keeps row k, and
// in phase two thread p eliminates the kept row k into position p.
constexpr int kMaxLargeN = 128;
constexpr int kLargeThreads = 128;

// The per-matrix values in shared memory: the matrix, the pivot row and
// column k; pivoted also the magnitudes, the kept row k, the row labels
// and their inverse.
__host__ __device__ constexpr int large_msize(int n, bool piv) {
  return n * (n + 1) + (piv ? 6 : 2) * n;
}

template <typename T, bool PIV>
__global__ void __launch_bounds__(kLargeThreads)
    gj_large_kernel(const T* __restrict__ a, T* __restrict__ out,
                    long long nb, int n, int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + 1;                     // padded column stride
  const int msize = large_msize(n, PIV);
  const int nn = n * n;
  T* base = reinterpret_cast<T*>(smem_raw);
  const int m = threadIdx.x / n, i = threadIdx.x - (threadIdx.x / n) * n;
  const bool active = m < per_block;
  T* S = base + (size_t)(active ? m : 0) * msize;  // S[j * ld + i] = A_ij
  T* piv = S + n * ld;                      // pivot row times 1 / pivot
  T* col = piv + n;                         // column k before step k
  T* pa = col + n;                          // pivoted: |M[i, k]|
  T* rowk = pa + n;                         // pivoted: row k before step k
  T* lab = rowk + n;                        // pivoted: row labels
  T* ilab = lab + n;                        // pivoted: their inverse
  for (long long b0 = (long long)blockIdx.x * per_block; b0 < nb;
       b0 += (long long)gridDim.x * per_block) {
    const int count = nb - b0 < per_block ? (int)(nb - b0) : per_block;
    const T* src = a + b0 * nn;
    for (int e = threadIdx.x; e < count * nn; e += kLargeThreads) {
      const int mm = e / nn, r = e - mm * nn, ii = r / n, jj = r - ii * n;
      base[(size_t)mm * msize + jj * ld + ii] = src[e];
    }
    if (PIV && active) lab[i] = T(i);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      int p = k;
      if (PIV) {
        if (active) pa[i] = i >= k ? absv(S[k * ld + i]) : T(-1);
        __syncthreads();
        if (active) {
          T bv = pa[k];
          for (int j = k + 1; j < n; ++j) {
            const T v = pa[j];
            if (v > bv) {
              bv = v;
              p = j;
            }
          }
        }
      }
      if (active) {
        const T inv = rcp_rn(S[k * ld + p]);
        // (k, k) of the inverse is 1 * inv
        piv[i] = i == k ? inv : mul_rn(S[i * ld + p], inv);
        col[i] = S[k * ld + i];
        if (PIV && p != k) {
          rowk[i] = S[i * ld + k];
          if (i == k) {
            const T t = lab[k];
            lab[k] = lab[p];
            lab[p] = t;
          }
        }
      }
      __syncthreads();
      if (active && i == k) {
        for (int j = 0; j < n; ++j) S[j * ld + i] = piv[j];
      } else if (PIV && active && i == p) {
        // row k, swapped into position p, eliminated
        const T c = col[k];
        for (int j = 0; j < n; ++j)
          S[j * ld + i] = sub_rn(j == k ? T(0) : rowk[j], mul_rn(c, piv[j]));
      } else if (active) {
        const T c = col[i];
        // column k holds the inverse's column k from here on: 0 - c * inv
        S[k * ld + i] = T(0);
#pragma unroll 4
        for (int j = 0; j < n; ++j)
          S[j * ld + i] = sub_rn(S[j * ld + i], mul_rn(c, piv[j]));
      }
      __syncthreads();
    }
    T* dst = out + b0 * nn;
    if (PIV) {
      // column j of the result is the stored column ilab[j]
      if (active) ilab[(int)lab[i]] = T(i);
      __syncthreads();
      for (int e = threadIdx.x; e < count * nn; e += kLargeThreads) {
        const int mm = e / nn, r = e - mm * nn, ii = r / n, jj = r - ii * n;
        const T* Sm = base + (size_t)mm * msize;
        dst[e] = Sm[(int)Sm[n * ld + 5 * n + jj] * ld + ii];
      }
    } else {
      for (int e = threadIdx.x; e < count * nn; e += kLargeThreads) {
        const int mm = e / nn, r = e - mm * nn, ii = r / n, jj = r - ii * n;
        dst[e] = base[(size_t)mm * msize + jj * ld + ii];
      }
    }
    __syncthreads();
  }
}

template <typename T, bool PIV>
int launch_large(const void* a, void* out, long long nb, int n,
                 cudaStream_t stream) {
  const int per_block = kLargeThreads / n;
  const size_t smem =
      (size_t)per_block * (size_t)large_msize(n, PIV) * sizeof(T);
  auto kernel = gj_large_kernel<T, PIV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kLargeThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return -4;
  const long long chunks = (nb + per_block - 1) / per_block;
  long long blocks = (long long)sms * per_sm;
  if (blocks > chunks) blocks = chunks;
  kernel<<<(unsigned)blocks, kLargeThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), nb, n, per_block);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- n > 128: huge
// A matrix no longer fits shared memory, so the huge variant keeps the
// batch in global memory, in place in `out` (a copy of the input), and
// launches two kernels per pivot step k (the simplest right design):
//
// * gj_huge_prep, one block per matrix: pivoted, the block finds the
//   first largest |M[i, k]| over i >= k by a reduction in shared memory
//   and swaps rows k and p (and their labels) in global memory; then it
//   writes the pivot row times the correctly rounded 1 / pivot (entry k:
//   1 / pivot itself) to `piv` and column k to `col`, per matrix.
// * gj_huge_update, a grid over (matrix, tile of 8 rows x 256 columns):
//   each entry is updated exactly as in the other variants (row k takes
//   the pivot row; entry (i, k) becomes 0 - c * inv; every other entry
//   x - c * piv[j], each product and difference rounded on its own), so
//   the result equals the plain version bit for bit, signed zeros aside.
//   The update reads only its own entry and the two per-matrix vectors,
//   so no block waits for another inside a step.
//
// Pivoted, a last launch writes each row's column j to column L_j
// through shared memory.  What bounds it: bytes, n^2 read and written per
// matrix and step, so n times the byte bound of one read and one write
// of the batch: 3.45 s at (64, 2145, 2145) float64 on an H100
// (chip_smoke.py), 1.61 ms per step, 2.9 TB/s of that traffic, where
// torch.linalg.inv takes 0.24 s.  A blocked trailing update (several
// pivot steps per pass) would cut the traffic by its block width.
constexpr int kHugeThreads = 256;
constexpr int kHugeRows = 8;  // rows per update block

template <typename T, bool PIV>
__global__ void __launch_bounds__(kHugeThreads)
    gj_huge_prep(T* __restrict__ a, T* __restrict__ piv,
                 T* __restrict__ col, int* __restrict__ lab, int n, int k) {
  __shared__ T sv[kHugeThreads];
  __shared__ int si[kHugeThreads];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  T* M = a + b * n * (long long)n;
  if (PIV) {
    T bv = T(-1);
    int bi = n;
    for (int i = k + t; i < n; i += kHugeThreads) {
      const T v = absv(M[(long long)i * n + k]);
      if (v > bv) {  // rows rise within a thread: the first largest stays
        bv = v;
        bi = i;
      }
    }
    sv[t] = bv;
    si[t] = bi;
    __syncthreads();
    for (int h = kHugeThreads / 2; h > 0; h >>= 1) {
      if (t < h) {
        const T v = sv[t + h];
        const int j = si[t + h];
        if (v > sv[t] || (v == sv[t] && j < si[t])) {
          sv[t] = v;
          si[t] = j;
        }
      }
      __syncthreads();
    }
    const int p = si[0] < n ? si[0] : k;  // (a column of NaNs: no swap)
    if (p != k) {
      T* rk = M + (long long)k * n;
      T* rp = M + (long long)p * n;
      for (int j = t; j < n; j += kHugeThreads) {
        const T x = rk[j];
        rk[j] = rp[j];
        rp[j] = x;
      }
      if (t == 0) {
        int* L = lab + b * n;
        const int x = L[k];
        L[k] = L[p];
        L[p] = x;
      }
    }
    __syncthreads();
  }
  const T* rk = M + (long long)k * n;
  const T inv = rcp_rn(rk[k]);
  T* pr = piv + b * n;
  T* cl = col + b * n;
  for (int j = t; j < n; j += kHugeThreads)
    pr[j] = j == k ? inv : mul_rn(rk[j], inv);
  for (int i = t; i < n; i += kHugeThreads) cl[i] = M[(long long)i * n + k];
}

template <typename T>
__global__ void __launch_bounds__(kHugeThreads)
    gj_huge_update(T* __restrict__ a, const T* __restrict__ piv,
                   const T* __restrict__ col, int n, int k, int col_tiles,
                   int tiles) {
  const long long b = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - b * tiles);
  const int j = (tile % col_tiles) * kHugeThreads + threadIdx.x;
  const int i0 = (tile / col_tiles) * kHugeRows;
  if (j >= n) return;
  T* M = a + b * n * (long long)n;
  const T pj = piv[b * n + j];
  const T* cl = col + b * n;
  T x[kHugeRows];
#pragma unroll
  for (int r = 0; r < kHugeRows; ++r)
    if (i0 + r < n) x[r] = M[(long long)(i0 + r) * n + j];
#pragma unroll
  for (int r = 0; r < kHugeRows; ++r) {
    const int i = i0 + r;
    if (i >= n) break;
    if (i == k) {
      x[r] = pj;
    } else {
      // column k holds the inverse's column from here on: 0 - c * inv
      x[r] = sub_rn(j == k ? T(0) : x[r], mul_rn(cl[i], pj));
    }
    M[(long long)i * n + j] = x[r];
  }
}

__global__ void gj_huge_labels(int* __restrict__ lab, long long total,
                               int n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x)
    lab[e] = (int)(e % n);
}

// Pivoted: row r's stored column j is the result's column L_j.
template <typename T>
__global__ void __launch_bounds__(kHugeThreads)
    gj_huge_unpermute(T* __restrict__ a, const int* __restrict__ lab,
                      int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  const long long r = blockIdx.x;  // matrix * n + row
  const int* L = lab + (r / n) * n;
  T* x = a + r * n;
  for (int j = threadIdx.x; j < n; j += kHugeThreads) row[j] = x[j];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kHugeThreads) x[L[j]] = row[j];
}

template <typename T>
int launch_huge(const void* a, void* out, void* piv, void* col, int* lab,
                long long nb, int n, int pivot, cudaStream_t stream) {
  const int col_tiles = (n + kHugeThreads - 1) / kHugeThreads;
  const int tiles = col_tiles * ((n + kHugeRows - 1) / kHugeRows);
  if (nb > 0x7fffffffLL / tiles || nb * n > 0x7fffffffLL) return -3;
  const size_t row_bytes = (size_t)n * sizeof(T);
  T* A = static_cast<T*>(out);
  T* P = static_cast<T*>(piv);
  T* C = static_cast<T*>(col);
  cudaError_t e = cudaMemcpyAsync(out, a, (size_t)nb * n * row_bytes,
                                  cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  if (pivot) {
    if (row_bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(gj_huge_unpermute<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)row_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    gj_huge_labels<<<1024, 256, 0, stream>>>(lab, nb * n, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  for (int k = 0; k < n; ++k) {
    if (pivot)
      gj_huge_prep<T, true><<<(unsigned)nb, kHugeThreads, 0, stream>>>(
          A, P, C, lab, n, k);
    else
      gj_huge_prep<T, false><<<(unsigned)nb, kHugeThreads, 0, stream>>>(
          A, P, C, lab, n, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gj_huge_update<T><<<(unsigned)(nb * tiles), kHugeThreads, 0, stream>>>(
        A, P, C, n, k, col_tiles, tiles);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (pivot) {
    gj_huge_unpermute<T><<<(unsigned)(nb * n), kHugeThreads, row_bytes,
                           stream>>>(A, lab, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int fdt_batched_inv(int is_double, int pivot, const void* a,
                               void* out, long long nb, int n, void* stream) {
  if (nb <= 0 || n < 1 || n > kMaxN) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pivot)
    return is_double ? launch_bucket<double, true>(a, out, nb, n, s)
                     : launch_bucket<float, true>(a, out, nb, n, s);
  return is_double ? launch_bucket<double, false>(a, out, nb, n, s)
                   : launch_bucket<float, false>(a, out, nb, n, s);
}

extern "C" int fdt_batched_inv_large(int is_double, int pivot,
                                     const void* a, void* out, long long nb,
                                     int n, void* stream) {
  if (nb <= 0 || n <= kMaxN || n > kMaxLargeN) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pivot)
    return is_double ? launch_large<double, true>(a, out, nb, n, s)
                     : launch_large<float, true>(a, out, nb, n, s);
  return is_double ? launch_large<double, false>(a, out, nb, n, s)
                   : launch_large<float, false>(a, out, nb, n, s);
}

// `piv` and `col` hold nb * n values each and `lab` nb * n ints (pivoted
// only; may be null otherwise): scratch for the step vectors and labels.
extern "C" int fdt_batched_inv_huge(int is_double, int pivot, const void* a,
                                    void* out, void* piv, void* col,
                                    int* lab, long long nb, int n,
                                    void* stream) {
  if (nb <= 0 || n <= kMaxLargeN || (pivot && lab == nullptr)) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch_huge<double>(a, out, piv, col, lab, nb, n, pivot, s)
             : launch_huge<float>(a, out, piv, col, lab, nb, n, pivot, s);
}
