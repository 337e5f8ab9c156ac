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
// rounding, so in the warp and large variants the pivoted mode too equals
// its plain version (ops/batched_inverse.py: batched_inv_plain(A,
// pivot=True)) bit for bit, signed zeros aside (the huge variant, blocked,
// rounds in another order).  The unpivoted instantiations are the kernels
// as they were.
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// ------------------------------------------------- 33 <= n <= 128: teams
// A row no longer fits a lane's registers, so the large variant spreads
// one matrix over a team of P = R^2 threads (one block), each thread an
// r x r tile in registers, laid out cyclically: thread (tr, tc), tid =
// tr R + tc, holds rows tr + R a and columns tc + R b (a, b < r).  The
// launch plan is ops/batched_inverse.py's large_plan: R = 8 (P = 64) for
// n <= 72, R = 16 (P = 256) above, r = ceil(n / R); the entries past n
// are zeros that never meet a real one.
//
// * One barrier per pivot step.  Step k touches shared memory only for
//   column k and row k: their owners (the R threads with tc = k mod R,
//   the R with tr = k mod R) post them to buffers that alternate with
//   the parity of k, one __syncthreads() orders the posts before the
//   reads, and every thread reads the pivot, forms the correctly rounded
//   inv = 1 / pivot and its own r entries of the scaled pivot row, reads
//   its r entries of column k and updates its tile: 2 n values written
//   and 2 n^2 / R read per step, where one thread per row over a matrix
//   in shared memory read and wrote it whole (~3 n^2 accesses).
// * The plain version's roundings.  Each entry becomes S - c_i piv_j,
//   the product and the difference rounded apart (no FMA).  Row k takes
//   c = -1 on a zeroed row (0 - (-1 piv_j) = piv_j exactly) and column k
//   a zeroed column (0 - c_i inv), so one loop updates the whole tile
//   and the result equals batched_inv_plain bit for bit, signed zeros
//   aside.
// * Registers cannot be indexed at run time, so the tile rotates: after
//   each pass of R steps every value moves one slot up in both its row
//   and its column (cyclically), which keeps row k and column k in slot
//   0, known at compile time; r passes bring the tile back.  The whole
//   team rotates at once, so the post buffers are indexed by slot and
//   owner (R slot + tr for column k, R slot + tc for row k) and need no
//   row numbers.
// * Loads overlap the elimination.  The grid is persistent (as many
//   blocks as fit on the SMs); each block walks the batch and copies its
//   next matrix into shared memory with cp.async (16-byte pieces where
//   the batch and n^2 values are 16-byte aligned, else one value each)
//   while it eliminates the current one from registers.  Results leave
//   from registers: a warp stores R consecutive values of each of 32 / R
//   rows per instruction, whole 32-byte sectors.
//
// Pivoted mode: before the posts of step k the owners of column k each
// take the first largest |M[i, k]| of their rows k <= i < n, a shuffle
// reduces it over the warp, and a second barrier orders the warps'
// candidates before every thread picks p, the first largest (the tie
// rule of torch.argmax).  The owners of row p post it as the pivot row
// and those of row k post the old row k, which after the barrier the
// owners of row p take in place of theirs (its slot is known only at
// run time: a branch per slot, one taken); thread 0 swaps the row
// labels, and column j of the result is stored to column lab[j].
//
// What bounds it: on paper bytes (each matrix read and written once:
// 0.50 ms at (65,536, 40, 40) float64 on an H100); with every product and
// difference rounded apart, also the 2 n^3 unfused float64 operations per
// matrix at the FP64 pipe's rate (~1.67e13 per second, 0.50 ms there as
// well).  This design takes 1.17 ms there, where one thread per row over
// a matrix in shared memory, 128 threads per block, took 4.24 ms, bound by
// shared memory (scripts/torch_k2_large.py, both in one run).  What holds
// it now is the chain of each step (barrier, pivot read, reciprocal,
// scaled row) that eight teams per SM hide only in part: float32, on a
// pipe twice as fast, is only 1.46x faster, and forming 1 / pivot once
// in its owner before the barrier (fewer operations, a longer chain) was
// slower at every shape.
constexpr int kMaxLargeN = 128;

// Values of shared memory that hold the staged matrix: n^2 rounded up to
// whole 16-byte pieces.
template <typename T>
__host__ __device__ constexpr int large_stage_len(int n) {
  return (n * n + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}

// Bytes of shared memory of the large variant (as large_plan computes
// them): the staged next matrix, column k and row k in two buffers each;
// pivoted also the old row k, the warps' candidates (values, then rows)
// in two buffers, and the row labels.
template <typename T>
constexpr size_t large_smem(int n, int R, int RT, bool piv) {
  return (size_t)(large_stage_len<T>(n) + 4 * R * RT +
                  (piv ? R * RT + R * R / 16 : 0)) * sizeof(T) +
         (piv ? (size_t)(R * R / 16 + R * RT) * sizeof(int) : 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy one n x n matrix into shared memory; every thread of the block
// takes part.
template <typename T, int P>
__device__ __forceinline__ void stage_matrix(T* dst, const T* src, int nn,
                                             int vec16) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec16) {
    for (int e = threadIdx.x * V; e < nn; e += P * V)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < nn; e += P)
      cp_async(dst + e, src + e, (int)sizeof(T));
  }
}

// Every value one slot up in its row and its column, cyclically.
template <typename T, int RT>
__device__ __forceinline__ void rotate_tile(T (&S)[RT][RT]) {
  T t[RT][RT];
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < RT; ++y)
      t[x][y] = S[x + 1 < RT ? x + 1 : 0][y + 1 < RT ? y + 1 : 0];
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < RT; ++y) S[x][y] = t[x][y];
}

template <typename T, int R, int RT, bool PIV>
__global__ void __launch_bounds__(R * R, R == 8 ? 4 : 1)
    gj_team_kernel(const T* __restrict__ a, T* __restrict__ out,
                   long long nb, int n, int vec16) {
  constexpr int P = R * R, W = P / 32, NBK = R * RT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = n * n;
  T* stage = reinterpret_cast<T*>(smem_raw);
  T* colb = stage + large_stage_len<T>(n);  // column k, by R slot + tr
  T* rowb = colb + 2 * NBK;                 // pivot row, by R slot + tc
  T* rkb = rowb + 2 * NBK;                  // pivoted: the old row k
  T* candv = rkb + NBK;                     // pivoted: warp candidates
  int* candi = reinterpret_cast<int*>(candv + 2 * W);
  int* lab = candi + 2 * W;                 // pivoted: row labels
  const int tid = threadIdx.x, tr = tid / R, tc = tid - tr * R;
  const int lane = tid & 31, warp = tid >> 5;

  long long m = blockIdx.x;  // < nb: the grid has at most nb blocks
  stage_matrix<T, P>(stage, a + m * nn, nn, vec16);
  cp_async_commit();
  for (; m < nb; m += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    T S[RT][RT];
#pragma unroll
    for (int x = 0; x < RT; ++x)
#pragma unroll
      for (int y = 0; y < RT; ++y) {
        const int i = tr + R * x, j = tc + R * y;
        S[x][y] = i < n && j < n ? stage[i * n + j] : T(0);
      }
    if (PIV)
      for (int j = tid; j < NBK; j += P) lab[j] = j;
    __syncthreads();  // the matrix is in registers: stage the next one
    if (m + gridDim.x < nb)
      stage_matrix<T, P>(stage, a + (m + gridDim.x) * nn, nn, vec16);
    cp_async_commit();

    int k = 0;
#pragma unroll 1
    for (int q = 0; q < RT; ++q) {
      // in pass q slot s holds rows (columns) tr + R ((s + q) mod RT):
      // row k and column k sit in slot 0 of their owners
#pragma unroll 1
      for (int t = 0; t < R && k < n; ++t, ++k) {
        T* cb = colb + (k & 1) * NBK;
        T* rb = rowb + (k & 1) * NBK;
        const bool rowk = tr == t, colk = tc == t;
        if (colk) {
#pragma unroll
          for (int x = 0; x < RT; ++x) cb[R * x + tr] = S[x][0];
        }
        int p = k, xp = 0;  // pivoted: the pivot row and its slot
        if (PIV) {
          T* cv = candv + (k & 1) * W;
          int* ci = candi + (k & 1) * W;
          T bv = T(-1);
          int bi = n;
          if (colk) {
#pragma unroll
            for (int x = 0; x < RT; ++x) {
              const int i = tr + R * (x + q < RT ? x + q : x + q - RT);
              const T v = absv(S[x][0]);
              if (i >= k && i < n && (v > bv || (v == bv && i < bi))) {
                bv = v;
                bi = i;
              }
            }
          }
#pragma unroll
          for (int off = R; off < 32; off <<= 1) {
            const T ov = __shfl_xor_sync(0xffffffffu, bv, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            if (ov > bv || (ov == bv && oi < bi)) {
              bv = ov;
              bi = oi;
            }
          }
          if (lane == t) {
            cv[warp] = bv;
            ci[warp] = bi;
          }
          __syncthreads();
          bv = cv[0];
          p = ci[0];
#pragma unroll
          for (int w = 1; w < W; ++w) {
            const T v = cv[w];
            const int i = ci[w];
            if (v > bv || (v == bv && i < p)) {
              bv = v;
              p = i;
            }
          }
          if (p >= n) p = k;  // no candidate (a NaN column): no swap
          xp = p / R - q;
          if (xp < 0) xp += RT;
          if (tid == 0 && p != k) {
            const int l = lab[k];
            lab[k] = lab[p];
            lab[p] = l;
          }
          if (tr == p % R) {
#pragma unroll
            for (int x = 0; x < RT; ++x)
              if (x == xp) {
#pragma unroll
                for (int y = 0; y < RT; ++y) rb[R * y + tc] = S[x][y];
              }
          }
          if (rowk && p != k) {
#pragma unroll
            for (int y = 0; y < RT; ++y) rkb[R * y + tc] = S[0][y];
          }
        } else if (rowk) {
#pragma unroll
          for (int y = 0; y < RT; ++y) rb[R * y + tc] = S[0][y];
        }
        __syncthreads();
        const T inv = rcp_rn(rb[t]);  // the pivot: column slot 0 of tc = t
        T piv[RT];
#pragma unroll
        for (int y = 0; y < RT; ++y) piv[y] = mul_rn(rb[R * y + tc], inv);
        if (colk) piv[0] = inv;  // 1 * inv: the inverse's entry (k, k)
        const bool rowp = PIV && p != k && tr == p % R;
        if (rowp) {
          // row p takes the old row k (column k: zeroed below)
#pragma unroll
          for (int x = 0; x < RT; ++x)
            if (x == xp) {
#pragma unroll
              for (int y = 0; y < RT; ++y) S[x][y] = rkb[R * y + tc];
            }
        }
        if (rowk) {
#pragma unroll
          for (int y = 0; y < RT; ++y) S[0][y] = T(0);
        }
        if (colk) {
#pragma unroll
          for (int x = 0; x < RT; ++x) S[x][0] = T(0);
        }
#pragma unroll
        for (int x = 0; x < RT; ++x) {
          // row k: c = -1 on a zeroed row gives the pivot row; row p
          // (pivoted): the old row k's entry in column k
          T c = cb[R * x + tr];
          if (rowp && x == xp) c = cb[t];
          if (x == 0 && rowk) c = T(-1);
#pragma unroll
          for (int y = 0; y < RT; ++y)
            S[x][y] = sub_rn(S[x][y], mul_rn(c, piv[y]));
        }
      }
      rotate_tile(S);
    }

    T* dst = out + m * nn;
#pragma unroll
    for (int x = 0; x < RT; ++x)
#pragma unroll
      for (int y = 0; y < RT; ++y) {
        const int i = tr + R * x, j = tc + R * y;
        if (i < n && j < n) dst[i * n + (PIV ? lab[j] : j)] = S[x][y];
      }
  }
}

template <typename T, int R, int RT, bool PIV>
int launch_team(const void* a, void* out, long long nb, int n, size_t smem,
                cudaStream_t stream, int* info) {
  if (smem != large_smem<T>(n, R, RT, PIV)) return -5;
  auto kernel = gj_team_kernel<T, R, RT, PIV>;
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
                                                      R * R, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return -4;
  long long blocks = (long long)sms * per_sm;
  if (blocks > nb) blocks = nb;
  const int vec16 =
      reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
      (size_t)n * n * sizeof(T) % 16 == 0;
  info[0] = per_sm;
  info[1] = (int)blocks;
  kernel<<<(unsigned)blocks, R * R, smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), nb, n, vec16);
  return (int)cudaGetLastError();
}

// The plans that large_plan gives: R = 8 with 5 <= r <= 9 (33 <= n <= 72),
// R = 16 with 5 <= r <= 8 (73 <= n <= 128); any other is refused (-5).
template <typename T, bool PIV>
int launch_large(const void* a, void* out, long long nb, int n, int R,
                 int RT, size_t smem, cudaStream_t s, int* info) {
  if (R * RT < n) return -5;
  if (R == 8) {
    switch (RT) {
      case 5: return launch_team<T, 8, 5, PIV>(a, out, nb, n, smem, s, info);
      case 6: return launch_team<T, 8, 6, PIV>(a, out, nb, n, smem, s, info);
      case 7: return launch_team<T, 8, 7, PIV>(a, out, nb, n, smem, s, info);
      case 8: return launch_team<T, 8, 8, PIV>(a, out, nb, n, smem, s, info);
      case 9: return launch_team<T, 8, 9, PIV>(a, out, nb, n, smem, s, info);
    }
  } else if (R == 16) {
    switch (RT) {
      case 5: return launch_team<T, 16, 5, PIV>(a, out, nb, n, smem, s, info);
      case 6: return launch_team<T, 16, 6, PIV>(a, out, nb, n, smem, s, info);
      case 7: return launch_team<T, 16, 7, PIV>(a, out, nb, n, smem, s, info);
      case 8: return launch_team<T, 16, 8, PIV>(a, out, nb, n, smem, s, info);
    }
  }
  return -5;
}

// ------------------------------------------------------- n > 128: huge
// A matrix no longer fits shared memory, so the huge variant keeps the
// batch in global memory, in place in `out` (a copy of the input), and
// runs Gauss-Jordan blocked by panels of w = kHugeW = 64 columns
// (Quintana-Orti, Quintana-Orti, Sun and van de Geijn, "A note on parallel
// matrix inversion", SIAM J. Sci. Comput. 22(5), 2001).  Three launches per
// panel [k, k + w):
//
// * gj_huge_panel, one block per matrix: Gauss-Jordan on the n x w column
//   panel alone, in sub-panels of b = 8 columns held whole (all n rows)
//   in shared memory (137 KB at n = 2145 in float64), or where n rows do
//   not fit (n > ~3,490 in float64, ~6,970 in float32) in per-matrix
//   global scratch that the block alone touches.  Pivoted, each step
//   takes the first largest |M[i, j]| over the rows not yet pivoted, in
//   the panel column as every earlier step left it, and swaps whole rows
//   of the sub-panel; then the panel's other columns take the sub-panel's
//   rank-b update, rows swapped, in global memory.  Stored back, the
//   panel's columns hold their final values Q (n x w); pivoted, the block
//   also writes the panel's swap record.
// * gj_huge_rows, one block per (matrix, panel row l): copies to scratch
//   R[l] = the row the swaps brought to position k + l, as it stood before
//   the panel, and (pivoted) Ro[l] = row k + l as it stood, which the
//   swaps sent outside the panel; the labels follow the swaps.
// * gj_huge_update, one block per (matrix, 64 x 64 tile of the columns
//   outside the panel): each entry becomes (its row in the panel ? 0 :
//   A[i, j], or Ro for a row the swaps sent out of the panel) +
//   sum_l Q[i, l] R[l, j], one rank-w product per matrix.  It reads Q from
//   the panel's columns and R, Ro from scratch and writes only columns
//   outside the panel, so no tile reads what another tile of the launch
//   writes.  Float64 runs it on the FP64 tensor cores (mma.sync m16n8k4
//   f64; Hopper's wgmma has no f64 type), float32 on register tiles that
//   sum in float64 (not TF32, which keeps ~3 digits; not FFMA: summed in
//   float32 the blocked order erred more than the plain version on
//   pivoted random blocks, summed in float64 no more than twice as much,
//   tests/test_torch_batched_inverse.py).  The panel's rank-b updates
//   sum in float64 too.
//
// What bounds it: the unblocked elimination it replaces (two launches per
// pivot step) read and wrote every matrix whole at each of its n steps,
// 3.45 s at (64, 2145, 2145) float64 on an H100 where torch.linalg.inv
// takes 0.24 s.  The operations bound, 2 n^3 per matrix at 67 TFLOP/s, is
// 18.9 ms there; a rank-w update does w / 8 flops per byte in float64
// against the card's ~20, so the update stays bound by bytes at w = 64:
// ceil(n / w) passes over the batch (34 at n = 2145), ~50 ms of memory
// time on those 64 blocks.  The panel costs w / b = 8 passes over its
// n x w columns per panel, about 8 passes over each matrix in all, on one
// SM per matrix; its pivot steps are latency (two or three block barriers
// each).  Measured (scripts/torch_k2_huge.py, NVIDIA H100 80GB HBM3,
// 700 W): at (512, 2145, 2145) the update moves 1.8 TB/s (a copy of the
// batch 3.0 TB/s) and takes 74% of a call, the panel 23% (PERF.md).
// Running the next panel on a second stream beside the update helped at
// 64 blocks but not at BDDC's 512 and 1, and was taken out.  The products
// sum in another order, with FMAs, so this variant does not equal
// batched_inv_plain bit for bit; it is held to it relative to
// torch.linalg.inv (chip_smoke.py, tests).  Pivoted, a first launch sets
// the labels and a last one writes each row's column j to column L_j
// through shared memory (global scratch where the sub-panel is there).
// The call reports the kernels it launched (3 ceil(n / w), + 2 pivoted),
// counted where each launch is made.
constexpr int kHugeW = 64;               // panel width w = update tile
constexpr int kHugeLds = kHugeW + 4;     // padded row stride of a tile
constexpr int kHugeThreads = 256;        // row copies, unpermute
constexpr int kPanelThreads = 512;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kSubMax = 8;               // sub-panel width b, at most
constexpr int kPanelRows = 8;            // rows per warp and pass
// pivoted, per matrix and panel: the swap record, the row at each panel
// position (as it stood before the panel), the positions outside the
// panel that took a panel row, the panel row each took, their count
constexpr int kRec = 3 * kHugeW + 1;

template <typename T>
__host__ __device__ constexpr int update_threads() {
  return sizeof(T) == 8 ? 128 : 256;
}

// Shared memory of the panel kernel: the sub-panel (n x b, by columns;
// in global scratch instead where it does not fit),
// the sub-panel's pivot rows and its rows before its swaps (b x w each),
// per-warp pivot candidates; then the swap records of the sub-panel and
// of the panel.
template <typename T>
size_t panel_smem(int n, bool sub_in_smem) {
  return ((sub_in_smem ? (size_t)n * kSubMax : 0) + 2 * kSubMax * kHugeW +
          kPanelWarps) * sizeof(T) +
         (size_t)(kPanelWarps + 3 * kSubMax + 3 * kHugeW + 2) * sizeof(int);
}

// Record the swap of positions kk and p (kk inside [base, base + size),
// p >= kk) in a permutation kept as perm[kk - base] = the row (as it
// stood when the record began) now at position kk, and a list of the
// positions outside the range that now hold another row (opos) with the
// row each holds (osrc).  Row swaps of Gauss-Jordan only ever send rows
// of the range outside it, so osrc stays inside the range.
__device__ void track_swap(int* perm, int* opos, int* osrc, int* cnt,
                           int base, int size, int kk, int p) {
  if (p < base + size) {
    const int t = perm[kk - base];
    perm[kk - base] = perm[p - base];
    perm[p - base] = t;
    return;
  }
  int j = 0;
  while (j < *cnt && opos[j] != p) ++j;
  if (j == *cnt) {
    opos[j] = p;
    osrc[j] = p;
    ++*cnt;
  }
  const int t = perm[kk - base];
  perm[kk - base] = osrc[j];
  osrc[j] = t;
}

// QG: the sub-panel in global scratch `qg` (else in shared memory; a
// template flag, so that the shared case keeps shared-memory addressing)
template <typename T, bool PIV, bool QG>
__global__ void __launch_bounds__(kPanelThreads)
    gj_huge_panel(T* __restrict__ a, T* qg, int* __restrict__ rec, int n,
                  int k, int wk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long ln = n, b = blockIdx.x;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Qs = QG ? qg + b * ln * kSubMax : sm;  // Qs[c * n + i]: sub-panel
  T* Rb = QG ? sm : sm + ln * kSubMax;      // its pivot rows
  T* Ro = Rb + kSubMax * kHugeW;           // its rows before its swaps
  T* wv = Ro + kSubMax * kHugeW;           // per-warp pivot candidates
  int* wi = reinterpret_cast<int*>(wv + kPanelWarps);
  int* permB = wi + kPanelWarps;           // swap record of the sub-panel
  int* oposB = permB + kSubMax;
  int* osrcB = oposB + kSubMax;
  int* permK = osrcB + kSubMax;            // swap record of the panel
  int* oposK = permK + kHugeW;
  int* osrcK = oposK + kHugeW;
  int* cnt = osrcK + kHugeW;               // [sub-panel, panel]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* M = a + b * ln * ln;
  if (tid < wk) permK[tid] = k + tid;
  if (tid == 0) cnt[1] = 0;
  for (int s = 0; s < wk; s += kSubMax) {
    const int bs = min(kSubMax, wk - s), s0 = k + s;
    for (int i = tid; i < n; i += kPanelThreads) {
      T v[kSubMax];
#pragma unroll
      for (int l = 0; l < kSubMax; ++l)
        if (l < bs) v[l] = M[i * ln + s0 + l];
#pragma unroll
      for (int l = 0; l < kSubMax; ++l)
        if (l < bs) Qs[(size_t)l * n + i] = v[l];
    }
    if (tid < bs) permB[tid] = s0 + tid;
    if (tid == 0) cnt[0] = 0;
    __syncthreads();
    for (int c = 0; c < bs; ++c) {
      const int kk = s0 + c;
      const T* qc = Qs + (size_t)c * n;
      int p = kk;
      if (PIV) {
        T bv = T(-1);
        int bi = n;
        for (int i = kk + tid; i < n; i += kPanelThreads) {
          const T v = absv(qc[i]);
          if (v > bv) {  // rows rise within a thread: the first largest
            bv = v;
            bi = i;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          wv[warp] = bv;
          wi[warp] = bi;
        }
        __syncthreads();
        bv = wv[0];
        bi = wi[0];
        for (int w = 1; w < kPanelWarps; ++w) {
          const T ov = wv[w];
          const int oi = wi[w];
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        p = bi < n ? bi : kk;  // (a column of NaNs: no swap)
        if (tid == 0 && p != kk) {
          track_swap(permB, oposB, osrcB, cnt, s0, bs, kk, p);
          track_swap(permK, oposK, osrcK, cnt + 1, k, wk, kk, p);
        }
      }
      // row p, moved to position kk, times 1 / pivot (entry c: 1 / pivot);
      // the thread of row p keeps row kk, which moves to position p
      const T inv = T(1) / qc[p];
      T pr[kSubMax], rk[kSubMax];
#pragma unroll
      for (int l = 0; l < kSubMax; ++l) {
        pr[l] = l >= bs ? T(0) : (l == c ? inv : Qs[(size_t)l * n + p] * inv);
        rk[l] = T(0);
      }
      T rkc = T(0);
      if (PIV && p != kk && (p - tid) % kPanelThreads == 0) {
#pragma unroll
        for (int l = 0; l < kSubMax; ++l)
          if (l < bs) rk[l] = Qs[(size_t)l * n + kk];
        rkc = qc[kk];
      }
      __syncthreads();
      for (int i = tid; i < n; i += kPanelThreads) {
        if (i == kk) {
#pragma unroll
          for (int l = 0; l < kSubMax; ++l)
            if (l < bs) Qs[(size_t)l * n + i] = pr[l];
          continue;
        }
        const bool moved = PIV && i == p && p != kk;
        const T ci = moved ? rkc : qc[i];
#pragma unroll
        for (int l = 0; l < kSubMax; ++l) {
          if (l >= bs) break;
          const T x = l == c ? T(0) : (moved ? rk[l] : Qs[(size_t)l * n + i]);
          Qs[(size_t)l * n + i] = x - ci * pr[l];
        }
      }
      __syncthreads();
    }
    // the rest of the panel's columns take the sub-panel's rank-bs update
    for (int e = tid; e < bs * kHugeW; e += kPanelThreads) {
      const int l = e / kHugeW, jj = e - l * kHugeW;
      if (jj < wk) {
        Rb[e] = M[permB[l] * ln + k + jj];
        Ro[e] = M[(s0 + l) * ln + k + jj];
      }
    }
    __syncthreads();
    const int j1 = lane, j2 = lane + 32;
    const bool u1 = j1 < wk && (j1 < s || j1 >= s + bs);
    const bool u2 = j2 < wk && (j2 < s || j2 >= s + bs);
    // the rank-bs update sums in float64 in both types (float32 too:
    // the blocked order rounds worse than the plain version's otherwise)
    double r1[kSubMax], r2[kSubMax];
#pragma unroll
    for (int l = 0; l < kSubMax; ++l) {
      r1[l] = (l < bs && u1) ? Rb[l * kHugeW + j1] : 0.0;
      r2[l] = (l < bs && u2) ? Rb[l * kHugeW + j2] : 0.0;
    }
    const int nsw = PIV ? cnt[0] : 0;
    for (int i0 = warp * kPanelRows; i0 < n;
         i0 += kPanelWarps * kPanelRows) {
      double x1[kPanelRows], x2[kPanelRows];
#pragma unroll
      for (int q = 0; q < kPanelRows; ++q) {
        const int i = i0 + q;
        int src = -2;  // -2: its own row; -1: a row of the sub-panel (0)
        if (i >= s0 && i < s0 + bs) src = -1;
        for (int t = 0; t < nsw; ++t)
          if (oposB[t] == i) src = osrcB[t] - s0;
        x1[q] = x2[q] = 0.0;
        if (i < n && src != -1) {
          if (u1) x1[q] = src == -2 ? M[i * ln + k + j1]
                                    : Ro[src * kHugeW + j1];
          if (u2) x2[q] = src == -2 ? M[i * ln + k + j2]
                                    : Ro[src * kHugeW + j2];
        }
      }
#pragma unroll
      for (int q = 0; q < kPanelRows; ++q) {
        const int i = i0 + q;
        if (i >= n) break;
#pragma unroll
        for (int l = 0; l < kSubMax; ++l) {
          if (l >= bs) break;
          const double qv = Qs[(size_t)l * n + i];
          x1[q] += qv * r1[l];
          x2[q] += qv * r2[l];
        }
        if (u1) M[i * ln + k + j1] = T(x1[q]);
        if (u2) M[i * ln + k + j2] = T(x2[q]);
      }
    }
    for (int i = tid; i < n; i += kPanelThreads) {
#pragma unroll
      for (int l = 0; l < kSubMax; ++l)
        if (l < bs) M[i * ln + s0 + l] = Qs[(size_t)l * n + i];
    }
    __syncthreads();
  }
  // pivoted: the panel's swap record, for gj_huge_rows and the update
  if (PIV) {
    int* r = rec + b * kRec;
    for (int e = tid; e < 3 * kHugeW; e += kPanelThreads) r[e] = permK[e];
    if (tid == 0) r[3 * kHugeW] = cnt[1];
  }
}

// The update's inputs, one block per (matrix, panel row l): R[l] = the
// row that the panel's swaps brought to position k + l, as it stood
// before the panel (unpivoted: row k + l); pivoted also Ro[l] = row k + l
// as it stood, which the swaps sent to a row outside the panel (the
// update reads such rows from Ro), and the labels follow the swaps.
template <typename T, bool PIV>
__global__ void __launch_bounds__(kHugeThreads)
    gj_huge_rows(const T* __restrict__ a, T* __restrict__ rsc,
                 T* __restrict__ rold, const int* __restrict__ rec,
                 int* __restrict__ lab, int n, int k, int wk) {
  const long long ln = n, b = blockIdx.x / wk;
  const int l = (int)(blockIdx.x - b * wk), tid = threadIdx.x;
  const T* M = a + b * ln * ln;
  const int* r = PIV ? rec + b * kRec : nullptr;
  const T* src = M + (PIV ? r[l] : k + l) * ln;
  T* R = rsc + (b * kHugeW + l) * ln;
  for (int j = tid; j < n; j += kHugeThreads) R[j] = src[j];
  if (!PIV) return;
  const T* old = M + (k + l) * ln;
  T* Ro = rold + (b * kHugeW + l) * ln;
  for (int j = tid; j < n; j += kHugeThreads) Ro[j] = old[j];
  if (l != 0) return;
  const int ncnt = r[3 * kHugeW];
  int* L = lab + b * ln;
  int v = 0;
  if (tid < wk)
    v = L[r[tid]];
  else if (tid < wk + ncnt)
    v = L[r[2 * kHugeW + tid - wk]];
  __syncthreads();
  if (tid < wk)
    L[k + tid] = v;
  else if (tid < wk + ncnt)
    L[r[kHugeW + tid - wk]] = v;
}

// d = a b + d on the FP64 tensor cores: a 16 x 4 (row), b 4 x 8 (col).
// Fragments (PTX ISA, mma.m16n8k4 .f64): g = lane / 4, t = lane % 4;
// a0 = A[g][t], a1 = A[g + 8][t]; b0 = B[t][g]; d0, d1 = D[g][2t, 2t + 1],
// d2, d3 = D[g + 8][2t, 2t + 1].
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// cp.async of one value (4 or 8 bytes, any alignment of its size), zero
// when !valid (src-size 0: nothing is read).
template <typename T>
__device__ __forceinline__ void cp_async_z(T* smem, const T* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 4 : 0));
}

// The trailing update, one block per (matrix, 64 x 64 tile of columns
// outside the panel [k, k + wk)): the tile becomes (its row in the panel
// ? 0 : A) + Q R, Q = A's panel columns for the tile's rows, R = the
// scratch rows for its columns, both copied to shared memory by cp.async
// (zero beyond n and wk) while the block loads A.  Pivoted, a row that the
// panel's swaps sent out of the panel starts from its scratch copy (rold).
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 8 ? 128 : 256)
    gj_huge_update(T* __restrict__ a, const T* __restrict__ rsc,
                   const T* __restrict__ rold, const int* __restrict__ rec,
                   int n, int k, int wk, int row_tiles, int ncols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = update_threads<T>();
  T* Qs = reinterpret_cast<T*>(smem_raw);  // Qs[r * kHugeLds + l]
  T* Rs = Qs + kHugeW * kHugeLds;          // Rs[l * kHugeLds + c]
  int* src = reinterpret_cast<int*>(Rs + kHugeW * kHugeLds);
  const int tiles = row_tiles * ncols, tid = threadIdx.x;
  const long long ln = n, b = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - b * tiles), c0 = tile % ncols;
  const int ct = c0 + (c0 < k / kHugeW ? 0 : 1);  // skip the panel's tile
  const int i0 = (tile / ncols) * kHugeW, j0 = ct * kHugeW;
  T* M = a + b * ln * ln;
  const T* R = rsc + b * kHugeW * ln;
  for (int e = tid; e < kHugeW * kHugeW; e += NT) {
    const int r = e / kHugeW, c = e - r * kHugeW;
    const bool qv = i0 + r < n && c < wk, rv = r < wk && j0 + c < n;
    cp_async_z(Qs + r * kHugeLds + c, M + (qv ? (i0 + r) * ln + k + c : 0),
               qv);
    cp_async_z(Rs + r * kHugeLds + c, R + (rv ? r * ln + j0 + c : 0), rv);
  }
  cp_async_commit();
  // where each row's A comes from: -1 zero (a panel row, or past n), -2
  // its own row, l >= 0 the panel row l that the swaps moved here
  if (tid < kHugeW) {
    const int i = i0 + tid;
    int from = (i >= n || (i >= k && i < k + wk)) ? -1 : -2;
    if (rec != nullptr && from == -2) {
      const int* r = rec + b * kRec;
      for (int t = 0; t < r[3 * kHugeW]; ++t)
        if (r[kHugeW + t] == i) from = r[2 * kHugeW + t] - k;
    }
    src[tid] = from;
  }
  __syncthreads();
  const T* Ro = rold + b * kHugeW * ln;
  auto base = [&](int r, int j) {
    const int from = src[r];
    if (from == -1 || j >= n) return T(0);
    return from == -2 ? M[(i0 + r) * ln + j] : Ro[from * ln + j];
  };
  if constexpr (sizeof(T) == 8) {
    // four warps of 32 x 32: 2 x 4 tensor-core tiles of 16 x 8 each
    // (eight warps of 16 x 32 were slower on the card)
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
    const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
    double acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          acc[mt][nt][h] = base(wr + mt * 16 + g + (h >> 1) * 8,
                                j0 + wc + nt * 8 + 2 * q + (h & 1));
    cp_async_wait_all();
    __syncthreads();
    const int wkp = (wk + 3) & ~3;
    for (int l = 0; l < wkp; l += 4) {
      double af[2][2], bf[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        af[mt][0] = Qs[(wr + mt * 16 + g) * kHugeLds + l + q];
        af[mt][1] = Qs[(wr + mt * 16 + g + 8) * kHugeLds + l + q];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt] = Rs[(l + q) * kHugeLds + wc + nt * 8 + g];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          dmma_16x8x4(acc[mt][nt], af[mt][0], af[mt][1], bf[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int i = i0 + wr + mt * 16 + g + (h >> 1) * 8;
          const int j = j0 + wc + nt * 8 + 2 * q + (h & 1);
          if (i < n && j < n) M[i * ln + j] = acc[mt][nt][h];
        }
  } else {
    // 16 x 16 threads of 4 x 4 entries: rows 4 ty + r, columns tx + 16 c;
    // summed in float64 (FMA on the CUDA cores) and rounded once
    const int ty = tid >> 4, tx = tid & 15;
    double acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = base(4 * ty + r, j0 + tx + 16 * c);
    cp_async_wait_all();
    __syncthreads();
    for (int l = 0; l < wk; ++l) {
      double qv[4], x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(4 * ty + r) * kHugeLds + l];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = Rs[l * kHugeLds + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fma(qv[r], x[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + 4 * ty + r, j = j0 + tx + 16 * c;
        if (i < n && j < n) M[i * ln + j] = T(acc[r][c]);
      }
  }
}

__global__ void gj_huge_labels(int* __restrict__ lab, long long total,
                               int n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x)
    lab[e] = (int)(e % n);
}

// Pivoted: row r's stored column j is the result's column L_j.  A block
// stages a row in shared memory (SMEM) or, where the sub-panel too lives
// in global memory, in its own row of `buf` (the update's R, free by
// then), and walks the rows r = blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename T, bool SMEM>
__global__ void __launch_bounds__(kHugeThreads)
    gj_huge_unpermute(T* __restrict__ a, const int* __restrict__ lab,
                      T* __restrict__ buf, long long rows, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = SMEM ? reinterpret_cast<T*>(smem_raw)
                : buf + (long long)blockIdx.x * n;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int* L = lab + (r / n) * n;
    T* x = a + r * n;
    for (int j = threadIdx.x; j < n; j += kHugeThreads) row[j] = x[j];
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kHugeThreads) x[L[j]] = row[j];
    __syncthreads();
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// 1 where the panel kernel holds its sub-panel (n x b) in shared memory on
// the current device, 0 where it keeps it in global scratch, < 0 where
// the query fails.
template <typename T>
int sub_panel_in_smem(int n) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  return panel_smem<T>(n, true) <= (size_t)optin;
}

// Values of scratch per matrix: R, pivoted Ro (kHugeW x n each), and the
// sub-panel (kSubMax x n) where it does not fit shared memory.
template <typename T>
long long huge_scratch_values(int n, int pivot, int in_smem) {
  return (1 + (pivot != 0)) * (long long)kHugeW * n +
         (in_smem ? 0 : (long long)kSubMax * n);
}

// `rsc`: nb * huge_scratch_values values (R, then pivoted Ro, then the
// sub-panels where they live in global memory); `iws` (pivoted): nb * n
// labels, then nb * kRec ints of swap records.  `info` reports the call:
// the kernels it launched, w, b, and 1 if the sub-panel sat in shared
// memory.
template <typename T>
int launch_huge(const void* a, void* out, void* rsc, int* iws, long long nb,
                int n, int pivot, cudaStream_t stream, int* info) {
  info[0] = 0;
  info[1] = kHugeW;
  info[2] = kSubMax;
  info[3] = 0;
  const int tiles_1d = (n + kHugeW - 1) / kHugeW;
  if (nb > 0x7fffffffLL / (tiles_1d * tiles_1d) || nb * n > 0x7fffffffLL)
    return -3;
  const int in_smem = sub_panel_in_smem<T>(n);
  if (in_smem < 0) return -in_smem;
  info[3] = in_smem;
  const size_t psmem = panel_smem<T>(n, in_smem);
  const size_t usmem =
      2 * (size_t)kHugeW * kHugeLds * sizeof(T) + kHugeW * sizeof(int);
  auto panel = pivot ? (in_smem ? gj_huge_panel<T, true, false>
                                : gj_huge_panel<T, true, true>)
                     : (in_smem ? gj_huge_panel<T, false, false>
                                : gj_huge_panel<T, false, true>);
  auto rows = pivot ? gj_huge_rows<T, true> : gj_huge_rows<T, false>;
  int rc = set_smem((const void*)panel, psmem);
  if (rc == 0) rc = set_smem((const void*)gj_huge_update<T>, usmem);
  if (rc != 0) return rc;
  T* A = static_cast<T*>(out);
  T* R = static_cast<T*>(rsc);
  T* Ro = pivot ? R + nb * kHugeW * n : nullptr;
  T* Qg = in_smem ? nullptr : R + (1 + (pivot != 0)) * nb * kHugeW * n;
  int* lab = iws;
  int* rec = pivot ? iws + nb * n : nullptr;
  cudaError_t e = cudaMemcpyAsync(out, a, (size_t)nb * n * n * sizeof(T),
                                  cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  // counts a launch where it is made
  auto launched = [&]() {
    e = cudaGetLastError();
    info[0] += e == cudaSuccess;
    return e == cudaSuccess;
  };
  if (pivot) {
    gj_huge_labels<<<1024, 256, 0, stream>>>(lab, nb * n, n);
    if (!launched()) return (int)e;
  }
  const int ncols = tiles_1d - 1;
  for (int k = 0; k < n; k += kHugeW) {
    const int wk = n - k < kHugeW ? n - k : kHugeW;
    panel<<<(unsigned)nb, kPanelThreads, psmem, stream>>>(A, Qg, rec, n, k,
                                                          wk);
    if (!launched()) return (int)e;
    rows<<<(unsigned)(nb * wk), kHugeThreads, 0, stream>>>(A, R, Ro, rec,
                                                           lab, n, k, wk);
    if (!launched()) return (int)e;
    gj_huge_update<T><<<(unsigned)(nb * tiles_1d * ncols),
                        update_threads<T>(), usmem, stream>>>(
        A, R, Ro, rec, n, k, wk, tiles_1d, ncols);
    if (!launched()) return (int)e;
  }
  if (pivot && in_smem) {
    // a row per block in shared memory (at most ~28 KB where the
    // sub-panel fits there)
    gj_huge_unpermute<T, true>
        <<<(unsigned)(nb * n), kHugeThreads, n * sizeof(T), stream>>>(
            A, lab, R, nb * n, n);
    if (!launched()) return (int)e;
  } else if (pivot) {
    // a row of R per block (R holds nb * kHugeW rows of n values)
    const long long grid = nb * kHugeW < 2048 ? nb * kHugeW : 2048;
    gj_huge_unpermute<T, false><<<(unsigned)grid, kHugeThreads, 0, stream>>>(
        A, lab, R, nb * n, n);
    if (!launched()) return (int)e;
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

// The large variant under a launch plan (ops/batched_inverse.py:
// large_plan): R, r and the shared memory in bytes; `info` reports the
// blocks per SM and the blocks of the grid.
extern "C" int fdt_batched_inv_large(int is_double, int pivot,
                                     const void* a, void* out, long long nb,
                                     int n, int R, int RT, long long smem,
                                     void* stream, int* info) {
  if (nb <= 0 || n <= kMaxN || n > kMaxLargeN || info == nullptr ||
      smem <= 0)
    return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (pivot)
    return is_double
               ? launch_large<double, true>(a, out, nb, n, R, RT, sm, s, info)
               : launch_large<float, true>(a, out, nb, n, R, RT, sm, s, info);
  return is_double
             ? launch_large<double, false>(a, out, nb, n, R, RT, sm, s, info)
             : launch_large<float, false>(a, out, nb, n, R, RT, sm, s, info);
}

extern "C" int fdt_batched_inv_huge(int is_double, int pivot, const void* a,
                                    void* out, void* rsc, int* iws,
                                    long long nb, int n, void* stream,
                                    int* info) {
  if (nb <= 0 || n <= kMaxLargeN || (pivot && iws == nullptr) ||
      info == nullptr)
    return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch_huge<double>(a, out, rsc, iws, nb, n, pivot, s, info)
             : launch_huge<float>(a, out, rsc, iws, nb, n, pivot, s, info);
}

// Scratch of the huge variant per matrix of size n on the current device:
// values (ints = 0) or ints (ints = 1), as launch_huge lays them out; < 0
// where the device query fails.
extern "C" long long fdt_batched_inv_huge_scratch(int is_double, int n,
                                                  int pivot, int ints) {
  if (ints) return pivot ? (long long)n + kRec : 0;
  const int in_smem = is_double ? sub_panel_in_smem<double>(n)
                                : sub_panel_in_smem<float>(n);
  if (in_smem < 0) return in_smem;
  return is_double ? huge_scratch_values<double>(n, pivot, in_smem)
                   : huge_scratch_values<float>(n, pivot, in_smem);
}
