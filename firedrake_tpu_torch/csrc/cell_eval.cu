// K1: the cell-kernel evaluator for the main path's form family, on Hopper.
//
// Replaces firedrake_tpu/compiler/pallas_eval.py::pallas_cell_eval, which
// evaluates one form's cell-last kernel over blocks of cells inside one
// pallas_call.  This kernel computes the same (ni, nj, C) element tensors
// for the family that compiler/cell_eval.py recognises: affine simplices
// (triangles, tets), scalar Lagrange P1/P2 arguments, and integrands that
// are sums of  c * prod(w) * {grad u . grad v | u v}  (rank 2) or
// c * prod(w) * {v | grad z . grad v}  (rank 1; the second is the action
// of a stiffness form on the coefficient z), with c a literal times at
// most two scalar Constants and prod(w) a product of scalar Lagrange
// coefficients (at most two in the integral, z included).
//
// What bounds it: bytes.  P1 in f64 reads 48 B of coordinates and writes
// 72 B of element matrix per cell (126 MB for 1M cells, 0.038 ms at
// 3.35 TB/s).  The per-cell algebra is a few hundred flops on odd sizes
// (3, 6, 4 or 10 dofs), far from the tensor cores' shapes, so they do not
// apply.  Three variants, chosen per form by compiler/cell_eval.py:
//
// * ref_kernel, forms without coefficients (the bilinear forms of the
//   main path).  On an affine cell the element matrix is
//     A_ij = |det J| (c_m M_ij + c_g sum_{t<=s} R_ij,ts K_ts),
//   with K = J^-1 J^-T and M, R the reference mass and stiffness tensors
//   (quadrature done once on the host, in float64).  The tensors (at most
//   55 x 7 values, P2 tets), the term literals and the Constants' device
//   pointers travel in a __grid_constant__ parameter struct: warp-uniform
//   reads go through the constant cache, with no staging and no barrier.
//   Test and trial spaces are equal, so only the upper triangle is
//   computed and both halves stored.  Each A_ij is computed and stored at
//   once, so no element matrix is held in registers: nothing spills.
//   Each thread takes two cells of its block's tile and issues both
//   cells' coordinate loads before either cell's arithmetic.  Template
//   parameters fix the sizes and which term kinds (mass, grad.grad) the
//   form holds, so the loops unroll and unused terms vanish.
// * act_kernel, the actions y = A_e z_e of forms without coefficients
//   (the matrix-free operators' matvec: action(a, z) is the action term
//   c * grad z . grad v, plus c * z * v for a mass part).  The same
//   reference tensors and K as ref_kernel give each A_ij of the upper
//   triangle, which is applied at once to the cell's z values
//   (y_i += A_ij z_j, y_j += A_ij z_i) and never stored: the kernel reads
//   coordinates and z and writes y, 256 B per P2 tet in float64.
// * quad_kernel, forms with coefficients (the load forms f * v of the main
//   path, and bilinear forms such as k * w * grad.grad).  The integrand
//   varies over the cell, so it is summed over quadrature points per
//   thread.  Its tables (up to 64 points on P2 tets, about 50 KB) exceed
//   the parameter space and are read from device memory with warp-uniform
//   addresses, without staging; rank 1 keeps its ni sums in registers,
//   rank 2 computes one entry at a time.
//
// Constants are read on the device: the kernel multiplies each term's
// literal by its Constants, so a launch needs no tensor operation besides
// the output allocation.
//
// Interface: plain C, called through ctypes.  The launch goes on the
// caller's stream and is not synchronised; the return value is
// cudaGetLastError() after the launch, or a negative code for arguments
// the kernel does not take.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 4;
constexpr int kMaxConsts = 4;
constexpr int kMaxCoeffs = 2;
constexpr int kPerTerm = 2;  // Constants, and coefficients, per term
// term kinds: 0 mass, 1 grad.grad, 2 load, 3 action grad z . grad v
constexpr int kGradGrad = 1, kAction = 3;
constexpr int kRef = 0, kQuad = 1, kAct = 2;
constexpr int kRefMass = 1, kRefGrad = 2;
constexpr int kSpecInts = 47;
constexpr int kHead = kMaxTerms + 12;  // literals, then cgrad (NV x TDIM)
constexpr int kThreads = 128;
constexpr int kCellsPerThread = 2;

// Everything a launch needs; ref holds the reference tensors of
// ref_kernel and act_kernel (capacity 1 for quad_kernel).
template <typename T, int CAP>
struct Params {
  const T* ce;
  const T* w[kMaxCoeffs];
  T* out;
  long long C;
  const T* konst[kMaxConsts];
  const T* tab;  // quad_kernel's tables in device memory
  int nterms, nq, ncoef, ni, nj;
  int zidx;  // the action operand's coefficient slot, -1 without one
  int wdof[kMaxCoeffs];
  int kind[kMaxTerms], nk[kMaxTerms], kidx[kMaxTerms][kPerTerm];
  int nw[kMaxTerms], widx[kMaxTerms][kPerTerm];
  int off_wq, off_bt, off_bs, off_dt, off_ds, off_w[kMaxCoeffs];
  T lit[kMaxTerms];
  T cgrad[12];
  T ref[CAP];
};

// Layout of the int32 spec array built by compiler/cell_eval.py:
//  0 mode (kRef, kQuad, kAct), 1 term kinds of ref_kernel and act_kernel
//  (kRefMass | kRefGrad),
//  2 nterms, 3 nq, 4 ncoef, 5-6 dofs of each coefficient,
//  7-34 four terms of (kind, nk, k0, k1, nw, w0, w1),
//  35-41 table offsets of quad_kernel (wq, bt, bs, dt, ds, w0, w1),
//  42 number of reference-tensor values of ref_kernel and act_kernel,
//  43-45 tdim, ni, nj, 46 the action operand's coefficient slot (-1: none).
// The float64 host array holds the term literals (4), the coordinate
// element's reference gradients (NV x TDIM, padded to 12), then the
// reference tensors.
struct Args {
  const int* spec;
  const double* dbl;
  int ndbl;
  const void *ce, *w0, *w1, *tab;
  void* out;
  long long C;
  const void* const* konst;
  int ni, nj;
  cudaStream_t stream;
};

template <typename T, int CAP>
int fill(Params<T, CAP>& p, const Args& a) {
  const int* v = a.spec;
  p.ce = static_cast<const T*>(a.ce);
  p.w[0] = static_cast<const T*>(a.w0);
  p.w[1] = static_cast<const T*>(a.w1);
  p.out = static_cast<T*>(a.out);
  p.C = a.C;
  for (int k = 0; k < kMaxConsts; ++k)
    p.konst[k] = static_cast<const T*>(a.konst[k]);
  p.tab = static_cast<const T*>(a.tab);
  p.nterms = v[2];
  p.nq = v[3];
  p.ncoef = v[4];
  p.ni = a.ni;
  p.nj = a.nj;
  for (int k = 0; k < kMaxCoeffs; ++k) p.wdof[k] = v[5 + k];
  p.zidx = v[46];
  if (p.zidx >= p.ncoef || (p.zidx >= 0 && p.wdof[p.zidx] != a.ni))
    return -2;
  for (int t = 0; t < kMaxTerms; ++t) {
    const int* u = v + 7 + 7 * t;
    p.kind[t] = u[0];
    p.nk[t] = u[1];
    p.kidx[t][0] = u[2];
    p.kidx[t][1] = u[3];
    p.nw[t] = u[4];
    p.widx[t][0] = u[5];
    p.widx[t][1] = u[6];
    for (int s = 0; s < kPerTerm; ++s) {
      if (s < p.nk[t] && (p.kidx[t][s] < 0 || p.kidx[t][s] >= kMaxConsts ||
                          !a.konst[p.kidx[t][s]]))
        return -2;
      if (s < p.nw[t] && (p.widx[t][s] < 0 || p.widx[t][s] >= p.ncoef))
        return -2;
    }
  }
  p.off_wq = v[35];
  p.off_bt = v[36];
  p.off_bs = v[37];
  p.off_dt = v[38];
  p.off_ds = v[39];
  p.off_w[0] = v[40];
  p.off_w[1] = v[41];
  const int nref = v[42];
  if (a.ndbl != kHead + nref || (v[0] != kQuad && nref != CAP)) return -3;
  for (int t = 0; t < kMaxTerms; ++t) p.lit[t] = (T)a.dbl[t];
  for (int k = 0; k < 12; ++k) p.cgrad[k] = (T)a.dbl[kMaxTerms + k];
  for (int r = 0; r < nref; ++r) p.ref[r] = (T)a.dbl[kHead + r];
  return 0;
}

// Closed-form inverse, the same cofactor formulas as compiler/batched.py
// (_detC/_invC).  J[g][t] = dx_g/dX_t; Ji[t][g] = (J^-1)[t][g].
template <typename T>
__device__ __forceinline__ void invert(T (&J)[2][2], T (&Ji)[2][2],
                                       T& det) {
  det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  Ji[0][0] = J[1][1] / det;
  Ji[0][1] = -J[0][1] / det;
  Ji[1][0] = -J[1][0] / det;
  Ji[1][1] = J[0][0] / det;
}

template <typename T>
__device__ __forceinline__ void invert(T (&g)[3][3], T (&Ji)[3][3],
                                       T& det) {
  det = g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[2][1]) -
        g[0][1] * (g[1][0] * g[2][2] - g[1][2] * g[2][0]) +
        g[0][2] * (g[1][0] * g[2][1] - g[1][1] * g[2][0]);
  Ji[0][0] = (g[1][1] * g[2][2] - g[1][2] * g[2][1]) / det;
  Ji[0][1] = -(g[0][1] * g[2][2] - g[0][2] * g[2][1]) / det;
  Ji[0][2] = (g[0][1] * g[1][2] - g[0][2] * g[1][1]) / det;
  Ji[1][0] = -(g[1][0] * g[2][2] - g[1][2] * g[2][0]) / det;
  Ji[1][1] = (g[0][0] * g[2][2] - g[0][2] * g[2][0]) / det;
  Ji[1][2] = -(g[0][0] * g[1][2] - g[0][2] * g[1][0]) / det;
  Ji[2][0] = (g[1][0] * g[2][1] - g[1][1] * g[2][0]) / det;
  Ji[2][1] = -(g[0][0] * g[2][1] - g[0][1] * g[2][0]) / det;
  Ji[2][2] = (g[0][0] * g[1][1] - g[0][1] * g[1][0]) / det;
}

// Jacobian from the coordinate element's constant reference gradients,
// its inverse and |det J|.
template <typename T, int TDIM, class P>
__device__ __forceinline__ void geometry(const P& p,
                                         const T (&x)[TDIM + 1][TDIM],
                                         T (&Ji)[TDIM][TDIM], T& adet) {
  T J[TDIM][TDIM];
#pragma unroll
  for (int g = 0; g < TDIM; ++g)
#pragma unroll
    for (int t = 0; t < TDIM; ++t) J[g][t] = T(0);
#pragma unroll
  for (int k = 0; k <= TDIM; ++k)
#pragma unroll
    for (int g = 0; g < TDIM; ++g)
#pragma unroll
      for (int t = 0; t < TDIM; ++t)
        J[g][t] += x[k][g] * p.cgrad[k * TDIM + t];
  T det;
  invert(J, Ji, det);
  adet = det < T(0) ? -det : det;
}

template <typename T, int TDIM>
__device__ __forceinline__ void load_coords(const T* __restrict__ ce,
                                            long long C, long long c,
                                            T (&x)[TDIM + 1][TDIM]) {
#pragma unroll
  for (int k = 0; k <= TDIM; ++k)
#pragma unroll
    for (int g = 0; g < TDIM; ++g)
      x[k][g] = c < C ? __ldcs(ce + (long long)(k * TDIM + g) * C + c)
                      : T(0);
}

// literal * Constants of term t (every thread reads the same scalars)
template <typename T, class P>
__device__ __forceinline__ T term_scale(const P& p, int t) {
  T s = p.lit[t];
#pragma unroll
  for (int u = 0; u < kPerTerm; ++u)
    if (u < p.nk[t]) s *= __ldg(p.konst[p.kidx[t][u]]);
  return s;
}

template <int TDIM, int NI, int NJ, int KINDS>
__host__ __device__ constexpr int ref_cap() {
  constexpr int pairs = NJ == 1 ? NI : NI * (NI + 1) / 2;
  return pairs * (((KINDS & kRefMass) ? 1 : 0) +
                  ((KINDS & kRefGrad) ? TDIM * (TDIM + 1) / 2 : 0));
}

template <typename T, int TDIM, int NI, int NJ, int KINDS>
__global__ void __launch_bounds__(kThreads)
    ref_kernel(const __grid_constant__
               Params<T, ref_cap<TDIM, NI, NJ, KINDS>()> p) {
  constexpr int NTS = TDIM * (TDIM + 1) / 2;
  constexpr bool MASS = KINDS & kRefMass, GRAD = KINDS & kRefGrad;
  constexpr int STRIDE = (MASS ? 1 : 0) + (GRAD ? NTS : 0);
  static_assert(NJ == 1 || NJ == NI, "rank 2 takes equal spaces");
  T cm = T(0), cg = T(0);
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t)
    if (t < p.nterms) {
      const T s = term_scale<T>(p, t);
      if (p.kind[t] == kGradGrad)
        cg += s;
      else
        cm += s;
    }
  const long long C = p.C;
  const long long c0 =
      (long long)blockIdx.x * (kThreads * kCellsPerThread) + threadIdx.x;
  T x[kCellsPerThread][TDIM + 1][TDIM];
#pragma unroll
  for (int u = 0; u < kCellsPerThread; ++u)
    load_coords<T, TDIM>(p.ce, C, c0 + u * kThreads, x[u]);
#pragma unroll
  for (int u = 0; u < kCellsPerThread; ++u) {
    const long long c = c0 + u * kThreads;
    if (c >= C) break;
    T Ji[TDIM][TDIM], adet;
    geometry<T, TDIM>(p, x[u], Ji, adet);
    const T m = cm * adet, gs = cg * adet;
    T K[NTS];
    if constexpr (GRAD) {
      int ts = 0;
#pragma unroll
      for (int t = 0; t < TDIM; ++t)
#pragma unroll
        for (int s = t; s < TDIM; ++s) {
          T acc = T(0);
#pragma unroll
          for (int g = 0; g < TDIM; ++g) acc += Ji[t][g] * Ji[s][g];
          K[ts++] = gs * acc;
        }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = (NJ == 1 ? 0 : i); j < NJ; ++j) {
        const int pair = NJ == 1 ? i : i * NJ - i * (i - 1) / 2 + (j - i);
        const T* r = p.ref + pair * STRIDE;
        T a = T(0);
        if constexpr (MASS) a = m * r[0];
        if constexpr (GRAD) {
#pragma unroll
          for (int ts = 0; ts < NTS; ++ts) a += r[(MASS ? 1 : 0) + ts] * K[ts];
        }
        __stcs(p.out + (long long)(i * NJ + j) * C + c, a);
        if (NJ > 1 && j != i)
          __stcs(p.out + (long long)(j * NJ + i) * C + c, a);
      }
  }
}

// y = A_e z_e, A_e as in ref_kernel with the test element on both sides,
// z the one coefficient (the action's operand).  Each A_ij of the upper
// triangle is applied at once: only y stays in registers.
template <typename T, int TDIM, int NI, int KINDS>
__global__ void __launch_bounds__(kThreads)
    act_kernel(const __grid_constant__
               Params<T, ref_cap<TDIM, NI, NI, KINDS>()> p) {
  constexpr int NTS = TDIM * (TDIM + 1) / 2;
  constexpr bool MASS = KINDS & kRefMass, GRAD = KINDS & kRefGrad;
  constexpr int STRIDE = (MASS ? 1 : 0) + (GRAD ? NTS : 0);
  T cm = T(0), cg = T(0);
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t)
    if (t < p.nterms) {
      const T s = term_scale<T>(p, t);
      if (p.kind[t] == kAction)
        cg += s;
      else
        cm += s;
    }
  const long long C = p.C;
  const long long c0 =
      (long long)blockIdx.x * (kThreads * kCellsPerThread) + threadIdx.x;
  const T* __restrict__ zp = p.w[p.zidx];
  T x[kCellsPerThread][TDIM + 1][TDIM];
  T z[kCellsPerThread][NI];
#pragma unroll
  for (int u = 0; u < kCellsPerThread; ++u) {
    const long long c = c0 + u * kThreads;
    load_coords<T, TDIM>(p.ce, C, c, x[u]);
#pragma unroll
    for (int j = 0; j < NI; ++j)
      z[u][j] = c < C ? __ldcs(zp + (long long)j * C + c) : T(0);
  }
#pragma unroll
  for (int u = 0; u < kCellsPerThread; ++u) {
    const long long c = c0 + u * kThreads;
    if (c >= C) break;
    T Ji[TDIM][TDIM], adet;
    geometry<T, TDIM>(p, x[u], Ji, adet);
    const T m = cm * adet, gs = cg * adet;
    T K[NTS];
    if constexpr (GRAD) {
      int ts = 0;
#pragma unroll
      for (int t = 0; t < TDIM; ++t)
#pragma unroll
        for (int s = t; s < TDIM; ++s) {
          T acc = T(0);
#pragma unroll
          for (int g = 0; g < TDIM; ++g) acc += Ji[t][g] * Ji[s][g];
          K[ts++] = gs * acc;
        }
    }
    T y[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) y[i] = T(0);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = i; j < NI; ++j) {
        const int pair = i * NI - i * (i - 1) / 2 + (j - i);
        const T* r = p.ref + pair * STRIDE;
        T a = T(0);
        if constexpr (MASS) a = m * r[0];
        if constexpr (GRAD) {
#pragma unroll
          for (int ts = 0; ts < NTS; ++ts) a += r[(MASS ? 1 : 0) + ts] * K[ts];
        }
        y[i] += a * z[u][j];
        if (j != i) y[j] += a * z[u][i];
      }
#pragma unroll
    for (int i = 0; i < NI; ++i) __stcs(p.out + (long long)i * C + c, y[i]);
  }
}

// Values of the coefficients at quadrature point q.
template <typename T, int KW, class P>
__device__ __forceinline__ void coeffs_at(const P& p,
                                          const T (&W)[kMaxCoeffs][KW],
                                          int q, T (&wv)[kMaxCoeffs]) {
#pragma unroll
  for (int k = 0; k < kMaxCoeffs; ++k) {
    T acc = T(0);
    if (k < p.ncoef) {
      const T* tw = p.tab + p.off_w[k] + q * p.wdof[k];
#pragma unroll
      for (int j = 0; j < KW; ++j)
        if (j < p.wdof[k]) acc += W[k][j] * __ldg(tw + j);
    }
    wv[k] = acc;
  }
}

// Integrand factors at point q, weight and |det J| included: the sum of
// the mass (or load) terms' and of the grad.grad terms' scalars.
template <typename T, int KW, class P>
__device__ __forceinline__ void factors_at(const P& p,
                                           const T (&W)[kMaxCoeffs][KW],
                                           const T (&sc)[kMaxTerms], T adet,
                                           int q, T& fm, T& fg) {
  T wv[kMaxCoeffs];
  coeffs_at<T, KW>(p, W, q, wv);
  fm = T(0);
  fg = T(0);
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t)
    if (t < p.nterms) {
      T f = sc[t];
#pragma unroll
      for (int u = 0; u < kPerTerm; ++u)
        if (u < p.nw[t]) f *= p.widx[t][u] == 0 ? wv[0] : wv[1];
      if (p.kind[t] == kGradGrad || p.kind[t] == kAction)
        fg += f;
      else
        fm += f;
    }
  const T s = __ldg(p.tab + p.off_wq + q) * adet;
  fm *= s;
  fg *= s;
}

// NI > 0: rank 1 with NI test dofs; NI == 0: rank 2, sizes p.ni, p.nj.
// ACT: rank 1 with action terms, whose grad z is summed at each point
// from the test tables and the operand's slot p.zidx.
template <typename T, int TDIM, int NI, bool ACT>
__global__ void __launch_bounds__(kThreads)
    quad_kernel(const __grid_constant__ Params<T, 1> p) {
  constexpr int KW = (TDIM + 1) * (TDIM + 2) / 2;  // P2 dofs
  const long long C = p.C;
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  T x[TDIM + 1][TDIM];
  load_coords<T, TDIM>(p.ce, C, c, x);
  T W[kMaxCoeffs][KW];
#pragma unroll
  for (int k = 0; k < kMaxCoeffs; ++k)
#pragma unroll
    for (int j = 0; j < KW; ++j)
      W[k][j] = (k < p.ncoef && j < p.wdof[k])
                    ? __ldcs(p.w[k] + (long long)j * C + c) : T(0);
  T sc[kMaxTerms];
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t)
    sc[t] = t < p.nterms ? term_scale<T>(p, t) : T(0);
  T Ji[TDIM][TDIM], adet;
  geometry<T, TDIM>(p, x, Ji, adet);
  const T* tb = p.tab;
  T Kf[TDIM][TDIM];  // J^-1 J^-T
#pragma unroll
  for (int t = 0; t < TDIM; ++t)
#pragma unroll
    for (int s = 0; s < TDIM; ++s) {
      T acc = T(0);
#pragma unroll
      for (int g = 0; g < TDIM; ++g) acc += Ji[t][g] * Ji[s][g];
      Kf[t][s] = acc;
    }
  if constexpr (NI > 0) {
    T A[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) A[i] = T(0);
    for (int q = 0; q < p.nq; ++q) {
      T fm, fg;
      factors_at<T, KW>(p, W, sc, adet, q, fm, fg);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        A[i] += fm * __ldg(tb + p.off_bt + q * NI + i);
      if constexpr (ACT) {
        // reference gradient of z at q, then K applied to it
        const T* d = tb + p.off_dt + q * NI * TDIM;
        T gz[TDIM], kg[TDIM];
#pragma unroll
        for (int t = 0; t < TDIM; ++t) gz[t] = T(0);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const T zj = p.zidx == 0 ? W[0][j] : W[1][j];
#pragma unroll
          for (int t = 0; t < TDIM; ++t) gz[t] += __ldg(d + j * TDIM + t) * zj;
        }
#pragma unroll
        for (int t = 0; t < TDIM; ++t) {
          kg[t] = T(0);
#pragma unroll
          for (int s = 0; s < TDIM; ++s) kg[t] += Kf[t][s] * gz[s];
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          T e = T(0);
#pragma unroll
          for (int t = 0; t < TDIM; ++t) e += __ldg(d + i * TDIM + t) * kg[t];
          A[i] += fg * e;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) __stcs(p.out + (long long)i * C + c, A[i]);
  } else {
    const int ni = p.ni, nj = p.nj;
    const bool sym = ni == nj;  // one element: equal tables
    for (int i = 0; i < ni; ++i)
      for (int j = sym ? i : 0; j < nj; ++j) {
        T a = T(0);
        for (int q = 0; q < p.nq; ++q) {
          T fm, fg;
          factors_at<T, KW>(p, W, sc, adet, q, fm, fg);
          a += fm * __ldg(tb + p.off_bt + q * ni + i) *
               __ldg(tb + p.off_bs + q * nj + j);
          const T* di = tb + p.off_dt + (q * ni + i) * TDIM;
          const T* dj = tb + p.off_ds + (q * nj + j) * TDIM;
          T e = T(0);
#pragma unroll
          for (int t = 0; t < TDIM; ++t) {
            T kd = T(0);
#pragma unroll
            for (int s = 0; s < TDIM; ++s) kd += Kf[t][s] * __ldg(dj + s);
            e += __ldg(di + t) * kd;
          }
          a += fg * e;
        }
        __stcs(p.out + (long long)(i * nj + j) * C + c, a);
        if (sym && j != i) __stcs(p.out + (long long)(j * nj + i) * C + c, a);
      }
  }
}

template <typename T, int TDIM, int NI, int NJ, int KINDS>
int launch_ref(const Args& a) {
  Params<T, ref_cap<TDIM, NI, NJ, KINDS>()> p;
  const int rc = fill(p, a);
  if (rc) return rc;
  const long long per_block = kThreads * kCellsPerThread;
  const long long blocks = (a.C + per_block - 1) / per_block;
  ref_kernel<T, TDIM, NI, NJ, KINDS>
      <<<(unsigned)blocks, kThreads, 0, a.stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TDIM, int NI, int KINDS>
int launch_act(const Args& a) {
  Params<T, ref_cap<TDIM, NI, NI, KINDS>()> p;
  const int rc = fill(p, a);
  if (rc) return rc;
  if (p.zidx < 0 || p.ncoef != 1) return -2;
  const long long per_block = kThreads * kCellsPerThread;
  const long long blocks = (a.C + per_block - 1) / per_block;
  act_kernel<T, TDIM, NI, KINDS>
      <<<(unsigned)blocks, kThreads, 0, a.stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TDIM, int NI, bool ACT>
int launch_quad(const Args& a) {
  Params<T, 1> p;
  const int rc = fill(p, a);
  if (rc) return rc;
  if (ACT != (p.zidx >= 0)) return -2;
  const long long blocks = (a.C + kThreads - 1) / kThreads;
  quad_kernel<T, TDIM, NI, ACT>
      <<<(unsigned)blocks, kThreads, 0, a.stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int TDIM, int NI, int NJ>
int launch_kinds(int kinds, const Args& a) {
  if (kinds == kRefMass) return launch_ref<T, TDIM, NI, NJ, kRefMass>(a);
  if constexpr (NJ == 1) {
    return -1;  // rank 1: load terms only
  } else {
    if (kinds == kRefGrad) return launch_ref<T, TDIM, NI, NJ, kRefGrad>(a);
    if (kinds == (kRefMass | kRefGrad))
      return launch_ref<T, TDIM, NI, NJ, kRefMass | kRefGrad>(a);
    return -1;
  }
}

// The action variant's term kinds: grad z . grad v, with or without z v.
template <typename T, int TDIM, int NI>
int launch_act_kinds(int kinds, const Args& a) {
  if (kinds == kRefGrad) return launch_act<T, TDIM, NI, kRefGrad>(a);
  if (kinds == (kRefMass | kRefGrad))
    return launch_act<T, TDIM, NI, kRefMass | kRefGrad>(a);
  return -1;
}

template <typename T, int TDIM, int NI>
int launch_quad_rank1(const Args& a) {
  return a.spec[46] >= 0 ? launch_quad<T, TDIM, NI, true>(a)
                         : launch_quad<T, TDIM, NI, false>(a);
}

// Element sizes: P1 has TDIM+1 dofs, P2 (TDIM+1)(TDIM+2)/2; rank 1 has nj 1.
template <typename T, int TDIM>
int launch_tdim(const Args& a) {
  constexpr int P1 = TDIM + 1, P2 = (TDIM + 1) * (TDIM + 2) / 2;
  const int mode = a.spec[0], kinds = a.spec[1];
  if (a.ni != P1 && a.ni != P2) return -1;
  if (mode == kQuad) {
    if (a.nj > 1) return launch_quad<T, TDIM, 0, false>(a);
    return a.ni == P1 ? launch_quad_rank1<T, TDIM, P1>(a)
                      : launch_quad_rank1<T, TDIM, P2>(a);
  }
  if (mode == kAct) {
    if (a.nj != 1) return -1;
    return a.ni == P1 ? launch_act_kinds<T, TDIM, P1>(kinds, a)
                      : launch_act_kinds<T, TDIM, P2>(kinds, a);
  }
  if (mode != kRef) return -1;
  if (a.nj == 1)
    return a.ni == P1 ? launch_kinds<T, TDIM, P1, 1>(kinds, a)
                      : launch_kinds<T, TDIM, P2, 1>(kinds, a);
  if (a.nj != a.ni) return -1;
  return a.ni == P1 ? launch_kinds<T, TDIM, P1, P1>(kinds, a)
                    : launch_kinds<T, TDIM, P2, P2>(kinds, a);
}

}  // namespace

// ptrs: coordinates, the two coefficients, quad_kernel's tables, the
// output, then the kMaxConsts Constants (unused ones null).
extern "C" int fdt_cell_eval(int is_double, const void* const* ptrs,
                             long long C, const int* spec, int nspec,
                             const double* dbl, int ndbl, void* stream) {
  if (nspec != kSpecInts || C <= 0) return -2;
  const int tdim = spec[43], ni = spec[44], nj = spec[45];
  const void* const* konst = ptrs + 5;
  const void* tab = ptrs[3];
  const int nterms = spec[2], ncoef = spec[4];
  if (nterms < 1 || nterms > kMaxTerms || ncoef < 0 || ncoef > kMaxCoeffs)
    return -2;
  for (int k = 0; k < ncoef; ++k)
    if (spec[5 + k] < 1 || spec[5 + k] > (tdim + 1) * (tdim + 2) / 2)
      return -2;
  if (spec[0] == kQuad && !tab) return -2;
  if (spec[46] >= 0 && spec[0] == kRef) return -2;
  const Args a{spec, dbl, ndbl, ptrs[0], ptrs[1], ptrs[2], tab,
               const_cast<void*>(ptrs[4]), C, konst, ni, nj,
               static_cast<cudaStream_t>(stream)};
  if (tdim == 2)
    return is_double ? launch_tdim<double, 2>(a) : launch_tdim<float, 2>(a);
  if (tdim == 3)
    return is_double ? launch_tdim<double, 3>(a) : launch_tdim<float, 3>(a);
  return -1;
}
