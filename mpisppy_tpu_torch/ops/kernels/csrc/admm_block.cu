// Fused ADMM iteration block for Hopper (sm_90a), f64.
//
// Replaces mpisppy_tpu/ops/kernels/pallas_kernel.py:_admm_block_kernel:
// n_steps fixed-rho relaxed ADMM steps (alpha, sigma runtime scalars) on
// the scaled shared-structure QP, then the unscaled residual maxima
// pri[s] and dua[s] of _unscaled_residuals.
//
// What bounds it: the bytes of the two big operands. A is (m, n) and the
// solve operator F is (n, n); at the UC reference scale (m = 26016,
// n = 13056, f64) that is 2.72 GB and 1.36 GB, far beyond any on-chip
// memory, and each step has three dependent products over them with
// only S (~10) scenario rows: skinny, memory-bound products (10 f64 FMAs
// per 8-byte element, a quarter of the CUDA cores' f64 rate at full
// HBM bandwidth). One step therefore streams A twice and F once, and the
// residual tail streams A twice more.
//
// Design: every product is one skinny-product template over B (R, C)
// row-major, for S <= 16 scenario rows of v per group (grid.y):
//   col: y = v . B    (reduce over B's rows; a CTA owns COL_TN columns)
//   row: y = v . B^T  (reduce over B's columns; a CTA owns ROW_TM rows)
// The reduction axis is split into P parts (grid.x = tiles x P), so the
// grid fills the card several times over. A CTA streams its tile-part of
// B through a STAGES-deep cp.async ring in shared memory, together with
// the S-row slice of v that the tile needs (never the whole vector).
// Each thread keeps an S x 4 register micro-tile of sums: it reads its
// matrix values from shared memory once each, and the S vector values
// as warp-uniform broadcasts (the row orientation swizzles its tile's
// 16-byte chunks so that lanes reading 32 different rows at one column
// do not conflict). The CTA's warps are summed in shared memory in a
// fixed order and the S x tile partials go to scratch (P, S, L). A
// second small kernel per product sums the P partials in the fixed
// order p = 0, 1, ... and applies the product's epilogue:
//   K1    k1_rhs   w . A         rhs = sigma x - q + r + g (rB zB - yB)
//   LINV1 linv1    rhs . F^T     ut (only with an L^-1 pair)
//   K2    k2_xupd  rhs . F       relaxed x, zB/yB with the clip to
//                  (or ut . F)   [lb, ub]
//   K3    k3_za    xt . A^T      relaxation, clip to [l, u], yA update,
//                                and w = rA zA - yA for the next K1
//   tail: pri_rows x . A^T, dua_cols yA . A (per-block maxima), finalize.
// w_prologue forms w once before the first step. Every kernel after it
// is launched with programmatic dependent launch: a product kernel
// fills its ring with matrix tiles while the kernel before it drains,
// and waits for that kernel only before it reads a vector.
// The split count, the tiles and the summation order depend on (m, n)
// only (the host computes the schedule: admm_block.py block_schedule),
// and every scenario's sums run in an order that does not depend on S
// or on its group, so a scenario-tiled call is bit-equal to an untiled
// one. No atomics: results are deterministic. Arithmetic is f64 FMA on
// the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) double admm_smem[];

namespace {

constexpr int NT = 256;                     // threads per product CTA
constexpr int NWARP = NT / 32;
constexpr int STAGES = 4;                   // depth of the cp.async ring
constexpr int COL_TN = 256;                 // col: output columns per CTA
constexpr int COL_KR = 16;                  // col: matrix rows per stage
constexpr int COL_TPR = COL_TN / 4;         // col: threads per row (4 cols)
constexpr int COL_G = NT / COL_TPR;         // col: row groups per CTA
constexpr int ROW_TM = 128;                 // row: output rows per CTA
constexpr int ROW_KC = 32;                  // row: matrix columns per stage
constexpr int ROW_CPR = ROW_KC / 2;         // row: 16-byte chunks per row
constexpr int ROW_RT = ROW_TM / 32;         // row: rows per thread
constexpr int RED_TN = 256;                 // sum kernels: elements per CTA
constexpr int SB_MAX = 16;
constexpr int STAGE_D = (COL_KR * COL_TN > ROW_TM * ROW_KC)
    ? COL_KR * COL_TN : ROW_TM * ROW_KC;    // doubles of B per stage
constexpr int VEC_D = SB_MAX * (COL_KR > ROW_KC ? COL_KR : ROW_KC);
constexpr int SMEM_BYTES = STAGES * (STAGE_D + VEC_D) * 8;
constexpr int ERR_SCHEDULE = 100000;        // refused schedule (not CUDA)

static_assert(COL_G * SB_MAX * COL_TN <= STAGES * STAGE_D &&
              NWARP * SB_MAX * ROW_TM <= STAGES * STAGE_D,
              "the warps' partial sums fit the ring");
static_assert((COL_KR * COL_TN / 2) % NT == 0 &&
              (ROW_TM * ROW_CPR) % NT == 0 && ROW_CPR % NWARP == 0 &&
              COL_KR % COL_G == 0 && ROW_CPR >= 8, "tile geometry");

enum Mode { RHS = 0, XUPD = 1, DUA = 2, ZA = 3, LINV1 = 4, PRI = 5 };

struct Args {
  const double *A, *F, *Ps, *g, *q, *l, *u, *lb, *ub, *rA, *rB, *Einv,
      *Ebinv, *Dinvc, *D;
  double *x, *yA, *yB, *zA, *zB, *rhs, *xt, *ut, *w, *part, *pri, *dua,
      *part_rows, *part_cpri, *part_cdua;
  // scenario strides of the scalings: 0 when shared, the row length
  // when given per scenario (rank 2)
  long long sPs, sg, srA, srB, sEinv, sEbinv, sDinvc, sD;
  int S, m, n, n_row_tiles, n_col_tiles;
  double sigma, alpha;
};

// One skinny product: B (R, C) row-major, v (S, R) for col or (S, C)
// for row, partial sums to part (P, S, C) or (P, S, R).
struct Prod {
  const double* B;
  const double* v;
  double* part;
  int R, C, S, tiles, per, vec16;
};

struct Split {
  int parts, per;   // parts of the reduction axis, stages per part
};

// max that propagates NaN like jnp.max
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// clip that propagates NaN like jnp.clip
__device__ __forceinline__ double clip(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copies into shared memory; a copy that is not ok reads
// nothing from src (a valid address all the same) and zero-fills dst
__device__ __forceinline__ void cp16(double* dst, const double* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp8(double* dst, const double* src,
                                    bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: every kernel of a call after the first
// is launched with the attribute, so it may start while the kernel
// before it drains. allow_next lets the next kernel launch; wait_prior
// blocks until the previous kernel has completed and its writes are
// visible. A kernel touches nothing that an earlier kernel of the call
// writes, and writes nothing that one reads, before wait_prior; the
// matrices A and F are read-only throughout.
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// B[o], B[o + 1] (row exists: row_ok; first column j) into dst[0..1];
// columns past C are zero-filled. One 16-byte copy when B's rows are
// 16-byte aligned, else two 8-byte copies.
__device__ __forceinline__ void copy_pair(double* dst, const Prod& pr,
                                          size_t o, bool row_ok, int j) {
  if (pr.vec16) {
    const bool ok = row_ok && j < pr.C;
    cp16(dst, ok ? pr.B + o : pr.B, ok);
  } else {
    const bool ok0 = row_ok && j < pr.C, ok1 = row_ok && j + 1 < pr.C;
    cp8(dst, ok0 ? pr.B + o : pr.B, ok0);
    cp8(dst + 1, ok1 ? pr.B + o + 1 : pr.B, ok1);
  }
}

// SB consecutive doubles of shared memory into registers
template <int SB>
__device__ __forceinline__ void vec_read(const double* p, double (&x)[SB]) {
  if constexpr (SB % 2 == 0) {
#pragma unroll
    for (int s = 0; s < SB; s += 2) {
      const double2 d = *reinterpret_cast<const double2*>(p + s);
      x[s] = d.x;
      x[s + 1] = d.y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < SB; ++s) x[s] = p[s];
  }
}

// col: part[p, s, j] = sum over the part's rows k of v[s, k] B[k, j].
// Thread t of row group g owns columns 2t, 2t+1, 128+2t, 128+2t+1 of the
// tile and rows g, g+4, g+8, g+12 of every stage; v's stage slice is
// kept [k][s], so a warp (one row group) reads it as broadcasts.
template <int SB>
__device__ __forceinline__ void col_body(const Prod& pr) {
  double* const bs = admm_smem;
  double* const vs = admm_smem + STAGES * STAGE_D;
  const int K = pr.R, N = pr.C;
  const int tile = blockIdx.x % pr.tiles, p = blockIdx.x / pr.tiles;
  const int s0 = blockIdx.y * SB, nv = min(SB, pr.S - s0);
  const int j0 = tile * COL_TN;
  const int st0 = p * pr.per;
  const int nst = min(pr.per, (K + COL_KR - 1) / COL_KR - st0);
  const int tid = threadIdx.x, g = tid / COL_TPR, t = tid % COL_TPR;

  auto load_b = [&](int i) {
    const int k0 = (st0 + i) * COL_KR;
    double* bd = bs + (i % STAGES) * STAGE_D;
#pragma unroll
    for (int q = 0; q < COL_KR * COL_TN / 2 / NT; ++q) {
      const int c = tid + q * NT;
      const int r = c / (COL_TN / 2), cc = c % (COL_TN / 2);
      const int k = k0 + r, j = j0 + 2 * cc;
      copy_pair(bd + r * COL_TN + 2 * cc, pr, (size_t)k * N + j, k < K, j);
    }
  };
  auto load_v = [&](int i) {
    const int k0 = (st0 + i) * COL_KR;
    double* vd = vs + (i % STAGES) * VEC_D;
    for (int e = tid; e < COL_KR * SB; e += NT) {
      const int s = e / COL_KR, r = e % COL_KR, k = k0 + r;
      const bool ok = s < nv && k < K;
      cp8(vd + r * SB + s, ok ? pr.v + (size_t)(s0 + s) * K + k : pr.v, ok);
    }
  };

  double acc[SB][4];
#pragma unroll
  for (int s = 0; s < SB; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[s][c] = 0.0;

  // the ring's first stages of the matrix before the previous kernel
  // has finished (the first commit group holds all of them), the
  // vector slices after
  allow_next();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < nst) load_b(i);
  wait_prior();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load_v(i);
    cp_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nst) {
      load_b(i + STAGES - 1);
      load_v(i + STAGES - 1);
    }
    cp_commit();
    const double* b = bs + (i % STAGES) * STAGE_D;
    const double* vv = vs + (i % STAGES) * VEC_D;
#pragma unroll
    for (int rr = 0; rr < COL_KR / COL_G; ++rr) {
      const int r = rr * COL_G + g;
      const double2 b0 =
          *reinterpret_cast<const double2*>(b + r * COL_TN + 2 * t);
      const double2 b1 = *reinterpret_cast<const double2*>(
          b + r * COL_TN + COL_TN / 2 + 2 * t);
      double x[SB];
      vec_read<SB>(vv + r * SB, x);
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        acc[s][0] = fma(x[s], b0.x, acc[s][0]);
        acc[s][1] = fma(x[s], b0.y, acc[s][1]);
        acc[s][2] = fma(x[s], b1.x, acc[s][2]);
        acc[s][3] = fma(x[s], b1.y, acc[s][3]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the row groups' sums, added in the order g = 0, 1, 2, 3
  double* const red = admm_smem;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    double* rs = red + (g * SB + s) * COL_TN;
    rs[2 * t] = acc[s][0];
    rs[2 * t + 1] = acc[s][1];
    rs[COL_TN / 2 + 2 * t] = acc[s][2];
    rs[COL_TN / 2 + 2 * t + 1] = acc[s][3];
  }
  __syncthreads();
  for (int idx = tid; idx < SB * COL_TN; idx += NT) {
    const int s = idx / COL_TN, jj = idx % COL_TN;
    if (s < nv && j0 + jj < N) {
      double y = red[s * COL_TN + jj];
#pragma unroll
      for (int gg = 1; gg < COL_G; ++gg)
        y += red[(gg * SB + s) * COL_TN + jj];
      pr.part[((size_t)p * pr.S + s0 + s) * N + j0 + jj] = y;
    }
  }
}

// row: part[p, s, i] = sum over the part's columns j of B[i, j] v[s, j].
// Lane l of every warp owns rows l, l+32, l+64, l+96 of the tile; warp w
// takes the column pairs w, w+8 of every stage. The tile's 16-byte
// chunk cc of row r is stored at chunk cc ^ (r & 7), so the 8 lanes of a
// quarter-warp read 8 distinct bank groups; v's stage slice is kept
// [pair][s][2], so a warp reads it as broadcasts.
template <int SB>
__device__ __forceinline__ void row_body(const Prod& pr) {
  double* const bs = admm_smem;
  double* const vs = admm_smem + STAGES * STAGE_D;
  const int M = pr.R, N = pr.C;
  const int tile = blockIdx.x % pr.tiles, p = blockIdx.x / pr.tiles;
  const int s0 = blockIdx.y * SB, nv = min(SB, pr.S - s0);
  const int i0 = tile * ROW_TM;
  const int st0 = p * pr.per;
  const int nst = min(pr.per, (N + ROW_KC - 1) / ROW_KC - st0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load_b = [&](int i) {
    const int c0 = (st0 + i) * ROW_KC;
    double* bd = bs + (i % STAGES) * STAGE_D;
#pragma unroll
    for (int q = 0; q < ROW_TM * ROW_CPR / NT; ++q) {
      const int c = tid + q * NT;
      const int r = c / ROW_CPR, cc = c % ROW_CPR;
      const int row = i0 + r, j = c0 + 2 * cc;
      copy_pair(bd + r * ROW_KC + 2 * (cc ^ (r & 7)), pr,
                (size_t)row * N + j, row < M, j);
    }
  };
  auto load_v = [&](int i) {
    const int c0 = (st0 + i) * ROW_KC;
    double* vd = vs + (i % STAGES) * VEC_D;
    for (int e = tid; e < ROW_KC * SB; e += NT) {
      const int s = e / ROW_KC, jl = e % ROW_KC, j = c0 + jl;
      const bool ok = s < nv && j < N;
      cp8(vd + (jl >> 1) * 2 * SB + 2 * s + (jl & 1),
          ok ? pr.v + (size_t)(s0 + s) * N + j : pr.v, ok);
    }
  };

  double acc[SB][ROW_RT];
#pragma unroll
  for (int s = 0; s < SB; ++s)
#pragma unroll
    for (int rt = 0; rt < ROW_RT; ++rt) acc[s][rt] = 0.0;

  // the ring's first stages of the matrix before the previous kernel
  // has finished (the first commit group holds all of them), the
  // vector slices after
  allow_next();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < nst) load_b(i);
  wait_prior();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load_v(i);
    cp_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nst) {
      load_b(i + STAGES - 1);
      load_v(i + STAGES - 1);
    }
    cp_commit();
    const double* b = bs + (i % STAGES) * STAGE_D;
    const double* vv = vs + (i % STAGES) * VEC_D;
#pragma unroll
    for (int qq = 0; qq < ROW_CPR / NWARP; ++qq) {
      const int q = qq * NWARP + warp;
      double2 bv[ROW_RT];
#pragma unroll
      for (int rt = 0; rt < ROW_RT; ++rt)
        bv[rt] = *reinterpret_cast<const double2*>(
            b + (lane + 32 * rt) * ROW_KC + 2 * (q ^ (lane & 7)));
      const double* xp = vv + q * 2 * SB;
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const double2 xv = *reinterpret_cast<const double2*>(xp + 2 * s);
#pragma unroll
        for (int rt = 0; rt < ROW_RT; ++rt) {
          acc[s][rt] = fma(xv.x, bv[rt].x, acc[s][rt]);
          acc[s][rt] = fma(xv.y, bv[rt].y, acc[s][rt]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the warps' sums, added in the order w = 0, 1, ..., 7
  double* const red = admm_smem;
#pragma unroll
  for (int s = 0; s < SB; ++s)
#pragma unroll
    for (int rt = 0; rt < ROW_RT; ++rt)
      red[(warp * SB + s) * ROW_TM + lane + 32 * rt] = acc[s][rt];
  __syncthreads();
  for (int idx = tid; idx < SB * ROW_TM; idx += NT) {
    const int s = idx / ROW_TM, ii = idx % ROW_TM;
    if (s < nv && i0 + ii < M) {
      double y = red[s * ROW_TM + ii];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) y += red[(w * SB + s) * ROW_TM + ii];
      pr.part[((size_t)p * pr.S + s0 + s) * M + i0 + ii] = y;
    }
  }
}

// One kernel name per product, so a profile reads each product's time.
#define SPLIT_KERNEL(NAME, BODY)                                  \
  template <int SB>                                               \
  __global__ void __launch_bounds__(NT, 1) NAME(Prod pr) {        \
    BODY<SB>(pr);                                                 \
  }
SPLIT_KERNEL(k1_rhs, col_body)
SPLIT_KERNEL(linv1, row_body)
SPLIT_KERNEL(k2_xupd, col_body)
SPLIT_KERNEL(k3_za, row_body)
SPLIT_KERNEL(pri_rows, row_body)
SPLIT_KERNEL(dua_cols, col_body)
#undef SPLIT_KERNEL

// y[s, j] = sum_p part[p, s, j] for p = 0, 1, ..., P-1 in that order,
// then the mode's epilogue at (s, j); grid (tiles of RED_TN, S). PRI and
// DUA also write their per-CTA maxima.
template <int MODE>
__device__ __forceinline__ void sum_body(const Args& a, int P) {
  constexpr bool ON_M = (MODE == ZA || MODE == PRI);
  const int L = ON_M ? a.m : a.n;
  const int s = blockIdx.y;
  const int j = blockIdx.x * RED_TN + threadIdx.x;
  __shared__ double r1[RED_TN], r2[RED_TN];
  double m1 = 0.0, m2 = 0.0;
  allow_next();
  wait_prior();
  if (j < L) {
    const size_t o = (size_t)s * L + j;
    const size_t ps = (size_t)a.S * L;
    double y = a.part[o];
#pragma unroll 8
    for (int q = 1; q < P; ++q) y += a.part[q * ps + o];
    const double al = a.alpha, om = 1.0 - a.alpha;
    if (MODE == RHS) {
      const double gg = a.g[s * a.sg + j], rb = a.rB[s * a.srB + j];
      a.rhs[o] = a.sigma * a.x[o] - a.q[o] + y
          + gg * (rb * a.zB[o] - a.yB[o]);
    } else if (MODE == LINV1) {
      a.ut[o] = y;
    } else if (MODE == XUPD) {
      const double gg = a.g[s * a.sg + j], rb = a.rB[s * a.srB + j];
      a.xt[o] = y;
      a.x[o] = al * y + om * a.x[o];
      const double zmix = al * (gg * y) + om * a.zB[o];
      const double yb = a.yB[o];
      const double zn = clip(zmix + yb / rb, a.lb[o], a.ub[o]);
      a.yB[o] = yb + rb * (zmix - zn);
      a.zB[o] = zn;
    } else if (MODE == ZA) {
      const double ra = a.rA[s * a.srA + j];
      const double zmix = al * y + om * a.zA[o];
      const double yv = a.yA[o];
      const double zn = clip(zmix + yv / ra, a.l[o], a.u[o]);
      const double yn = yv + ra * (zmix - zn);
      a.yA[o] = yn;
      a.zA[o] = zn;
      a.w[o] = ra * zn - yn;
    } else if (MODE == PRI) {
      m1 = fabs(a.Einv[s * a.sEinv + j] * (y - a.zA[o]));
    } else {  // DUA
      const double gg = a.g[s * a.sg + j];
      const double xv = a.x[o];
      m1 = fabs(a.D[s * a.sD + j] * xv - a.Ebinv[s * a.sEbinv + j] * a.zB[o]);
      m2 = fabs(a.Dinvc[s * a.sDinvc + j]
                * (a.Ps[s * a.sPs + j] * xv + a.q[o] + y + gg * a.yB[o]));
    }
  }
  if (MODE == PRI || MODE == DUA) {
    const int t = threadIdx.x;
    r1[t] = m1;
    r2[t] = m2;
    __syncthreads();
    for (int w = RED_TN / 2; w > 0; w >>= 1) {
      if (t < w) {
        r1[t] = nanmax(r1[t], r1[t + w]);
        r2[t] = nanmax(r2[t], r2[t + w]);
      }
      __syncthreads();
    }
    if (t == 0) {
      if (MODE == PRI) {
        a.part_rows[(size_t)s * a.n_row_tiles + blockIdx.x] = r1[0];
      } else {
        a.part_cpri[(size_t)s * a.n_col_tiles + blockIdx.x] = r1[0];
        a.part_cdua[(size_t)s * a.n_col_tiles + blockIdx.x] = r2[0];
      }
    }
  }
}

#define SUM_KERNEL(NAME, MODE)                                         \
  __global__ void __launch_bounds__(RED_TN) NAME(Args a, int P) {      \
    sum_body<MODE>(a, P);                                              \
  }
SUM_KERNEL(k1_rhs_sum, RHS)
SUM_KERNEL(linv1_sum, LINV1)
SUM_KERNEL(k2_xupd_sum, XUPD)
SUM_KERNEL(k3_za_sum, ZA)
SUM_KERNEL(pri_rows_sum, PRI)
SUM_KERNEL(dua_cols_sum, DUA)
#undef SUM_KERNEL

// w = rA zA - yA before the first step (later steps: k3_za_sum)
__global__ void __launch_bounds__(RED_TN) w_prologue(Args a) {
  const int s = blockIdx.y, i = blockIdx.x * RED_TN + threadIdx.x;
  allow_next();
  if (i < a.m) {
    const size_t o = (size_t)s * a.m + i;
    a.w[o] = a.rA[s * a.srA + i] * a.zA[o] - a.yA[o];
  }
}

// pri[s], dua[s] from the per-CTA partial maxima (one block each)
__global__ void __launch_bounds__(NT) finalize_kernel(Args a) {
  const int s = blockIdx.x;
  __shared__ double r1[NT], r2[NT];
  double p = 0.0, d = 0.0;
  wait_prior();
  for (int t = threadIdx.x; t < a.n_row_tiles; t += NT)
    p = nanmax(p, a.part_rows[(size_t)s * a.n_row_tiles + t]);
  for (int t = threadIdx.x; t < a.n_col_tiles; t += NT) {
    p = nanmax(p, a.part_cpri[(size_t)s * a.n_col_tiles + t]);
    d = nanmax(d, a.part_cdua[(size_t)s * a.n_col_tiles + t]);
  }
  r1[threadIdx.x] = p;
  r2[threadIdx.x] = d;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      r1[threadIdx.x] = nanmax(r1[threadIdx.x], r1[threadIdx.x + w]);
      r2[threadIdx.x] = nanmax(r2[threadIdx.x], r2[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.pri[s] = r1[0];
    a.dua[s] = r2[0];
  }
}

// launch on st; pdl: may overlap the drain of the kernel before it
template <typename... Params, typename... Actual>
cudaError_t launch(bool pdl, void (*kernel)(Params...), dim3 grid,
                   dim3 block, int smem, cudaStream_t st,
                   Actual... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

#define LAUNCH(...)                                  \
  do {                                               \
    cudaError_t e_ = launch(__VA_ARGS__);            \
    ++*launches;                                     \
    if (e_ == cudaSuccess) e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

template <int SB>
int run(const Args& a, const Split* sc, int n_steps, int l_inv_pair,
        cudaStream_t st, int* launches) {
  const void* split[] = {
      (const void*)k1_rhs<SB>, (const void*)linv1<SB>,
      (const void*)k2_xupd<SB>, (const void*)k3_za<SB>,
      (const void*)pri_rows<SB>, (const void*)dua_cols<SB>};
  for (const void* f : split) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  const Split a_col = sc[0], f_col = sc[1], f_row = sc[2], a_row = sc[3];
  const int groups = (a.S + SB - 1) / SB;
  const int a16 = (a.n % 2 == 0 && ((uintptr_t)a.A & 15) == 0) ? 1 : 0;
  const int f16 = (a.n % 2 == 0 && ((uintptr_t)a.F & 15) == 0) ? 1 : 0;
  const int ct = (a.n + COL_TN - 1) / COL_TN;
  const int rt_m = (a.m + ROW_TM - 1) / ROW_TM;
  const int rt_n = (a.n + ROW_TM - 1) / ROW_TM;
  const Prod k1{a.A, a.w, a.part, a.m, a.n, a.S, ct, a_col.per, a16};
  const Prod lv{a.F, a.rhs, a.part, a.n, a.n, a.S, rt_n, f_row.per, f16};
  const Prod k2{a.F, l_inv_pair ? a.ut : a.rhs, a.part, a.n, a.n, a.S, ct,
                f_col.per, f16};
  const Prod k3{a.A, a.xt, a.part, a.m, a.n, a.S, rt_m, a_row.per, a16};
  const Prod pr{a.A, a.x, a.part, a.m, a.n, a.S, rt_m, a_row.per, a16};
  const Prod du{a.A, a.yA, a.part, a.m, a.n, a.S, ct, a_col.per, a16};
  const dim3 blk(NT), rblk(RED_TN);
  const dim3 g_acol(ct * a_col.parts, groups), g_fcol(ct * f_col.parts,
                                                        groups);
  const dim3 g_frow(rt_n * f_row.parts, groups), g_arow(rt_m * a_row.parts,
                                                         groups);
  const dim3 r_m((a.m + RED_TN - 1) / RED_TN, a.S);
  const dim3 r_n((a.n + RED_TN - 1) / RED_TN, a.S);
  constexpr int SM = SMEM_BYTES;
  LAUNCH(false, w_prologue, r_m, rblk, 0, st, a);
  for (int it = 0; it < n_steps; ++it) {
    LAUNCH(true, k1_rhs<SB>, g_acol, blk, SM, st, k1);
    LAUNCH(true, k1_rhs_sum, r_n, rblk, 0, st, a, a_col.parts);
    if (l_inv_pair) {
      LAUNCH(true, linv1<SB>, g_frow, blk, SM, st, lv);
      LAUNCH(true, linv1_sum, r_n, rblk, 0, st, a, f_row.parts);
    }
    LAUNCH(true, k2_xupd<SB>, g_fcol, blk, SM, st, k2);
    LAUNCH(true, k2_xupd_sum, r_n, rblk, 0, st, a, f_col.parts);
    LAUNCH(true, k3_za<SB>, g_arow, blk, SM, st, k3);
    LAUNCH(true, k3_za_sum, r_m, rblk, 0, st, a, a_row.parts);
  }
  LAUNCH(true, pri_rows<SB>, g_arow, blk, SM, st, pr);
  LAUNCH(true, pri_rows_sum, r_m, rblk, 0, st, a, a_row.parts);
  LAUNCH(true, dua_cols<SB>, g_acol, blk, SM, st, du);
  LAUNCH(true, dua_cols_sum, r_n, rblk, 0, st, a, a_col.parts);
  LAUNCH(true, finalize_kernel, dim3(a.S), blk, 0, st, a);
  return 0;
}

// a split of `stages` stages: every part non-empty, together all of them
bool split_ok(const Split& s, int stages) {
  return s.parts >= 1 && s.per >= 1 && (long long)s.parts * s.per >= stages
      && (long long)(s.parts - 1) * s.per < stages;
}

}  // namespace

extern "C" {

// ptrs: A F Ps g q l u lb ub rA rB Einv Ebinv Dinvc D x yA yB zA zB rhs xt
//       ut w part pri dua part_rows part_cpri part_cdua (30 device
//       pointers);
// strides: sPs sg srA srB sEinv sEbinv sDinvc sD; dims: S m n;
// scalars: sigma alpha;
// sched: the geometry the host planned for (COL_TN COL_KR ROW_TM ROW_KC
//        RED_TN), then (parts, stages per part) of A col, F col, F row,
//        A row (13 ints).
// x/yA/yB/zA/zB are updated in place. Returns 0, the first CUDA error,
// or ERR_SCHEDULE for a schedule made for another geometry or shape;
// *launches counts the kernels launched.
int admm_block_run(const uint64_t* ptrs, const long long* strides,
                   const int* dims, const double* scalars, const int* sched,
                   int n_steps, int l_inv_pair, void* stream,
                   int* launches) {
  Args a;
  const double* const* cp = reinterpret_cast<const double* const*>(ptrs);
  double* const* mp = reinterpret_cast<double* const*>(ptrs);
  a.A = cp[0]; a.F = cp[1]; a.Ps = cp[2]; a.g = cp[3]; a.q = cp[4];
  a.l = cp[5]; a.u = cp[6]; a.lb = cp[7]; a.ub = cp[8]; a.rA = cp[9];
  a.rB = cp[10]; a.Einv = cp[11]; a.Ebinv = cp[12]; a.Dinvc = cp[13];
  a.D = cp[14];
  a.x = mp[15]; a.yA = mp[16]; a.yB = mp[17]; a.zA = mp[18];
  a.zB = mp[19]; a.rhs = mp[20]; a.xt = mp[21]; a.ut = mp[22];
  a.w = mp[23]; a.part = mp[24]; a.pri = mp[25]; a.dua = mp[26];
  a.part_rows = mp[27]; a.part_cpri = mp[28]; a.part_cdua = mp[29];
  a.sPs = strides[0]; a.sg = strides[1]; a.srA = strides[2];
  a.srB = strides[3]; a.sEinv = strides[4]; a.sEbinv = strides[5];
  a.sDinvc = strides[6]; a.sD = strides[7];
  a.S = dims[0]; a.m = dims[1]; a.n = dims[2];
  a.n_row_tiles = (a.m + RED_TN - 1) / RED_TN;
  a.n_col_tiles = (a.n + RED_TN - 1) / RED_TN;
  a.sigma = scalars[0];
  a.alpha = scalars[1];
  *launches = 0;
  const Split sc[4] = {{sched[5], sched[6]}, {sched[7], sched[8]},
                       {sched[9], sched[10]}, {sched[11], sched[12]}};
  if (sched[0] != COL_TN || sched[1] != COL_KR || sched[2] != ROW_TM
      || sched[3] != ROW_KC || sched[4] != RED_TN
      || !split_ok(sc[0], (a.m + COL_KR - 1) / COL_KR)
      || !split_ok(sc[1], (a.n + COL_KR - 1) / COL_KR)
      || !split_ok(sc[2], (a.n + ROW_KC - 1) / ROW_KC)
      || !split_ok(sc[3], (a.n + ROW_KC - 1) / ROW_KC))
    return ERR_SCHEDULE;
  if (a.S <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the scenario group size: the smallest instantiated SB >= S (capped
  // at 16), so a 10-scenario batch runs no idle accumulator rows
  if (a.S <= 1) return run<1>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 2) return run<2>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 4) return run<4>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 6) return run<6>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 8) return run<8>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 10) return run<10>(a, sc, n_steps, l_inv_pair, st, launches);
  if (a.S <= 12) return run<12>(a, sc, n_steps, l_inv_pair, st, launches);
  return run<SB_MAX>(a, sc, n_steps, l_inv_pair, st, launches);
}

}  // extern "C"
