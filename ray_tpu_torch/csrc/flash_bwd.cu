// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: ray_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (driven by _flash_bwd, the custom_vjp backward of flash_attention).  Same
// function: with P = exp(S * scale - lse) recomputed from the forward's f32
// lse and dS = P * (dO V^T - delta) * scale, where delta = rowsum(dO * O)
// comes in precomputed,
//   dQ = dS K                  (dS rounded to K's dtype first, as the
//                               Pallas kernel casts it before the product)
//   dV = sum over the n_rep q heads of P^T dO
//   dK = sum over the n_rep q heads of dS^T Q
// over q/dO [b, sq, hq, d] and k/v [b, skv, hkv, d] in the public layout,
// read in place, KV head hi / (hq / hkv); lse and delta are [b, hq, sq] f32.
// Causal or not; rows and keys past the sequence end are zero-filled and
// masked, so any sequence length works.
//
// What bounds it: operations.  At the training shapes (b 8, s 2048, hq 8,
// hkv 4, d 128, causal) dQ does 6 d flops per (query, key) pair (S, dP, dQ)
// and dK/dV 8 d (S, dP, dV, dK) over 134M pairs: about 770 and 1000 flops
// per byte each must read and write, well above the H100's ridge of about
// 295 in bf16, so both are compute-bound.
//
// dK/dV in bf16 (flash_bwd_dkv_wgmma_kernel): one block per (128-row kv
// tile, kv head, batch), the heaviest causal tiles (the first) launched
// first.  K and V stay resident in shared memory; one producer warp streams
// the Q and dO tiles (64 q rows, by TMA) and the lse and delta rows of
// every q head of the group, from the diagonal on when causal, through a
// ring of two stages.  The producer warpgroup gives its registers to the
// consumers (setmaxnreg 40 / 232): two f32 64 x d accumulators per thread
// plus S^T and dP^T do not fit in the 168 a thread of a 384-thread launch.
// Two consumer warpgroups own 64 kv rows each and compute the transposes
// directly, so nothing is transposed through shared memory:
//   S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, both operands K-major
//                                   in shared memory;
//   P^T, dS^T                       on the accumulator fragments, masked
//                                   only in the tiles that cross the
//                                   diagonal or a sequence end;
//   dV += P^T dO, dK += dS^T Q      wgmma with A from registers (the P^T
//                                   and dS^T fragments rounded to bf16)
//                                   and dO, Q read MN-major from the same
//                                   tiles.
// dK and dV accumulate in f32 registers.  The tensor cores take bf16, so P
// and dS are rounded to bf16 before the dV and dK products, where the
// Pallas kernel keeps them in f32; the plain version rounds the same way.
//
// dK/dV in f32 and dQ in both dtypes (flash_bwd_dkv_kernel,
// flash_bwd_dq_kernel): FMA loops over tiles staged in shared memory as
// f32 (an f32 input would run as TF32 on the tensor cores; dQ's move to
// them is later work).
//   dQ:    one block of 256 threads per (64-row q tile, q head, batch).  The
//          TPU's sequential KV grid axis becomes a loop over 64-row K/V
//          tiles inside the block, which stops at the diagonal when causal.
//          Each thread owns 4 x 4 of S and dP and 4 rows x d/16 columns of
//          the dQ accumulator.
//   dK/dV: one block per (64-row kv tile, kv head, batch).  It loops over
//          the n_rep q heads of its kv head and over the q tiles from the
//          diagonal on, accumulating dK and dV in f32 registers (4 kv rows
//          x d/16 columns each per thread).  P and dS go to shared memory
//          transposed, so both products read them along contiguous rows.
// Every output tile belongs to exactly one block: no atomics, and a run
// gives the same bits every time, as the TPU kernels' grids do.
#include "hopper.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int BM = 64;               // q rows per tile
constexpr int BN = 64;               // kv rows per tile
constexpr int kThreads = 256;

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage 64 rows (from row0, stride `rs` elements) of a [*, D] slice into
// shared memory as f32 with leading dimension LD; rows past `n` are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n, int64_t rs) {
  constexpr int VEC = VecN<T>::N;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float f[VEC];
    if (row0 + r < n) {
      load_vec(src + (int64_t)(row0 + r) * rs + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// Stage 64 entries of an f32 [sq] row (lse or delta); past `n` -> 0.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < BM; i += kThreads)
    dst[i] = (row0 + i < n) ? src[row0 + i] : 0.f;
}

// s[i][j] = A[ty*4+i] . B[tx+16j] and t[i][j] = C[ty*4+i] . E[tx+16j] over
// D, for four rows and four columns per thread (A, C: [64, LD] row tiles;
// B, E: [64, LD] column tiles).
template <int D, int LD>
__device__ __forceinline__ void two_products(
    const float* A, const float* B, const float* C, const float* E,
    float s[4][4], float t[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; t[i][j] = 0.f; }
#pragma unroll 2
  for (int kd = 0; kd < D; kd += 4) {
    float4 a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + kd);
      c[i] = *reinterpret_cast<const float4*>(C + (ty * 4 + i) * LD + kd);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + kd);
      e[j] = *reinterpret_cast<const float4*>(E + (tx + 16 * j) * LD + kd);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j], y = t[i][j];
        x = fmaf(a[i].x, b[j].x, x); y = fmaf(c[i].x, e[j].x, y);
        x = fmaf(a[i].y, b[j].y, x); y = fmaf(c[i].y, e[j].y, y);
        x = fmaf(a[i].z, b[j].z, x); y = fmaf(c[i].z, e[j].z, y);
        x = fmaf(a[i].w, b[j].w, x); y = fmaf(c[i].w, e[j].w, y);
        s[i][j] = x; t[i][j] = y;
      }
  }
}

// acc[i][c] += sum_n W[ty*4+i][n] * X[n][tx+16c] over a 64-wide tile:
// W is [64, LDP] (row per output row), X is [64, LD].
template <int D, int LD, int LDP>
__device__ __forceinline__ void accumulate(float acc[4][D / 16],
                                           const float* W, const float* X,
                                           int ty, int tx) {
  constexpr int CPT = D / 16;
#pragma unroll 2
  for (int n = 0; n < 64; n += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(W + (ty * 4 + i) * LDP + n);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      const float x0 = X[(n + 0) * LD + col];
      const float x1 = X[(n + 1) * LD + col];
      const float x2 = X[(n + 2) * LD + col];
      const float x3 = X[(n + 3) * LD + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float t = acc[i][c];
        t = fmaf(w4[i].x, x0, t);
        t = fmaf(w4[i].y, x1, t);
        t = fmaf(w4[i].z, x2, t);
        t = fmaf(w4[i].w, x3, t);
        acc[i][c] = t;
      }
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * 64 * (D + 4) + BM * (BN + 4) + 2 * BM) * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * 64 * (D + 4) + 2 * BN * (BM + 4) + 2 * BM) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv,
    int hq, int hkv, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BN + 4;
  constexpr int CPT = D / 16;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;         // [BM, LDP]: dS rounded to K's dtype
  float* lse_s = dSs + BM * LDP;
  float* delta_s = lse_s + BM;

  const int q0 = blockIdx.x * BM;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (hq / hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t qrs = (int64_t)hq * D;
  const int64_t krs = (int64_t)hkv * D;
  const T* qb = q + ((int64_t)bi * sq * hq + hi) * D;
  const T* dob = dout + ((int64_t)bi * sq * hq + hi) * D;
  const T* kb = k + ((int64_t)bi * skv * hkv + hk) * D;
  const T* vb = v + ((int64_t)bi * skv * hkv + hk) * D;
  const int64_t row_off = ((int64_t)bi * hq + hi) * sq;

  stage<T, D, LD>(Qs, qb, q0, sq, qrs);
  stage<T, D, LD>(dOs, dob, q0, sq, qrs);
  stage_row(lse_s, lse + row_off, q0, sq);
  stage_row(delta_s, delta + row_off, q0, sq);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(skv, q0 + BM) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();                 // previous tile's readers are done
    stage<T, D, LD>(Ks, kb, k0, skv, krs);
    stage<T, D, LD>(Vs, vb, k0, skv, krs);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D, LD>(Qs, Ks, dOs, Vs, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row < sq && col < skv && !(causal && col > row)) {
          const float p = expf(s[i][j] * scale - lse_s[r]);
          ds = round_to(p * (dp[i][j] - delta_s[r]) * scale, k);
        }
        dSs[r * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    accumulate<D, LD, LDP>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    T* drow = dq + ((int64_t)bi * sq + row) * qrs + (int64_t)hi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(drow + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int skv, int hq, int hkv, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BM + 4;
  constexpr int CPT = D / 16;
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Pt = dOs + BM * LD;         // [BN, LDP]: P transposed (kv, q)
  float* dSt = Pt + BN * LDP;        // [BN, LDP]: dS transposed
  float* lse_s = dSt + BN * LDP;
  float* delta_s = lse_s + BM;

  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int n_rep = hq / hkv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t qrs = (int64_t)hq * D;
  const int64_t krs = (int64_t)hkv * D;
  const int64_t kv_off = ((int64_t)bi * skv * hkv + hk) * D;

  stage<T, D, LD>(Ks, k + kv_off, k0, skv, krs);
  stage<T, D, LD>(Vs, v + kv_off, k0, skv, krs);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) { dk_acc[i][c] = 0.f; dv_acc[i][c] = 0.f; }

  // Causal: q tiles wholly above this kv tile's first key see none of it.
  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int hi = hk * n_rep + rep;
    const T* qb = q + ((int64_t)bi * sq * hq + hi) * D;
    const T* dob = dout + ((int64_t)bi * sq * hq + hi) * D;
    const int64_t row_off = ((int64_t)bi * hq + hi) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += BM) {
      __syncthreads();               // previous tile's readers are done
      stage<T, D, LD>(Qs, qb, q0, sq, qrs);
      stage<T, D, LD>(dOs, dob, q0, sq, qrs);
      stage_row(lse_s, lse + row_off, q0, sq);
      stage_row(delta_s, delta + row_off, q0, sq);
      __syncthreads();

      // s, dp: q rows ty*4+i, kv columns tx+16j of this (q, kv) tile pair.
      float s[4][4], dp[4][4];
      two_products<D, LD>(Qs, Ks, dOs, Vs, s, dp, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        float p4[4], ds4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const int row = q0 + r;
          float p = 0.f, ds = 0.f;
          if (row < sq && col < skv && !(causal && col > row)) {
            p = expf(s[i][j] * scale - lse_s[r]);
            ds = p * (dp[i][j] - delta_s[r]) * scale;
          }
          p4[i] = p;
          ds4[i] = ds;
        }
        *reinterpret_cast<float4*>(Pt + c * LDP + ty * 4) =
            make_float4(p4[0], p4[1], p4[2], p4[3]);
        *reinterpret_cast<float4*>(dSt + c * LDP + ty * 4) =
            make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
      }
      __syncthreads();
      // dV[kv row] += P^T dO; dK[kv row] += dS^T Q (rows ty*4+i of the tile).
      accumulate<D, LD, LDP>(dv_acc, Pt, dOs, ty, tx);
      accumulate<D, LD, LDP>(dk_acc, dSt, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= skv) continue;
    const int64_t off = ((int64_t)bi * skv + row) * krs + (int64_t)hk * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(dk + off + tx + 16 * c, dk_acc[i][c]);
      store(dv + off + tx + 16 * c, dv_acc[i][c]);
    }
  }
}


// ------------------------------------------- dK/dV in bf16: wgmma and TMA
constexpr int kTcBN = 128;             // kv rows a block: two warpgroups
constexpr int kTcBM = 64;              // q rows a stage
constexpr int kTcStages = 2;
constexpr int kTcThreads = 384;        // two consumer warpgroups + a producer
constexpr int kTcArrivals = 8;         // consumer warps releasing a stage
constexpr int kTcLoaders = 32;         // producer lanes filling a stage

template <int D>
struct DkvSmem {
  static constexpr int KV = kTcBN * D * 2;
  static constexpr int QT = kTcBM * D * 2;
  static constexpr int ROW = kTcBM * 4;             // an lse / delta tile
  static constexpr int STAGE = 2 * QT + 1024;       // Q, dO, lse, delta
  static constexpr int K = 0;
  static constexpr int V = KV;
  __host__ __device__ static constexpr int Q(int s) {
    return 2 * KV + s * STAGE;
  }
  __host__ __device__ static constexpr int DO(int s) {
    return Q(s) + QT;
  }
  __host__ __device__ static constexpr int LSE(int s) {
    return DO(s) + QT;
  }
  __host__ __device__ static constexpr int DELTA(int s) {
    return LSE(s) + 512;
  }
  static constexpr int BARS = 2 * KV + kTcStages * STAGE;
  // Barriers (kv_full, full[], empty[]) and the alignment slack.
  static constexpr int BYTES = BARS + 8 * (1 + 2 * kTcStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int sq, int skv, int hq, int hkv,
    int causal, float scale, float scale_log2) {
  using namespace hopper;
  using L = DkvSmem<D>;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* smem = align1024(tc_smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kTcStages;

  const int k0 = blockIdx.z * kTcBN;   // kv tile 0 sees the most q tiles
  const int hk = blockIdx.x;
  const int bi = blockIdx.y;
  const int n_rep = hq / hkv;
  // Causal: q tiles wholly above this kv tile's first key see none of it.
  const int q_begin = causal ? (k0 / kTcBM) * kTcBM : 0;
  const int n_qt = q_begin < sq ? (sq - q_begin + kTcBM - 1) / kTcBM : 0;
  const int n_it = n_rep * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], kTcLoaders);
      mbar_init(&empty[s], kTcArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // The producer: warp 8.  Lane 0 issues the TMA loads of the Q and dO
    // tiles; the warp copies the lse and delta rows itself (a row of a
    // ragged length starts off 16-byte alignment, where a 1-D TMA load
    // faulted), then every lane arrives.
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::KV);
        tma_tile<D, kTcBN>(smem + L::K, &kmap, kv_full, hk, k0, bi);
        tma_tile<D, kTcBN>(smem + L::V, &vmap, kv_full, hk, k0, bi);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kTcStages;
        const int hi = hk * n_rep + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * kTcBM;
        if (it >= kTcStages) mbar_wait(&empty[s], (it / kTcStages - 1) & 1);
        if (lane == 0) {
          mbar_expect(&full[s], 2 * L::QT);
          tma_tile<D, kTcBM>(smem + L::Q(s), &qmap, &full[s], hi, q0, bi);
          tma_tile<D, kTcBM>(smem + L::DO(s), &domap, &full[s], hi, q0, bi);
        }
        const int64_t row = ((int64_t)bi * hq + hi) * sq;
        float* lse_s = reinterpret_cast<float*>(smem + L::LSE(s));
        float* delta_s = reinterpret_cast<float*>(smem + L::DELTA(s));
        for (int c = lane; c < kTcBM; c += 32) {
          const bool in = q0 + c < sq;
          lse_s[c] = in ? lse[row + q0 + c] : 0.f;
          delta_s[c] = in ? delta[row + q0 + c] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    setmaxnreg_inc<232>();

    // Consumer warpgroup wg: kv rows kv0 + r and + 8 of its accumulator
    // layout, r = 16 warp + lane / 4; q columns 8 j + col0 (+ 1) of a tile.
    const int lane = threadIdx.x % 32;
    const int kvw = k0 + wg * 64;      // this warpgroup's first kv row
    const int kv0 = kvw + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint8_t* ks = smem + L::K + wg * 64 * Cols<D>::RB;
    const uint8_t* vs = smem + L::V + wg * 64 * Cols<D>::RB;

    float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dkacc[i] = 0.f;
      dvacc[i] = 0.f;
    }

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kTcStages;
      const int q0 = q_begin + (it % n_qt) * kTcBM;
      mbar_wait(&full[s], (it / kTcStages) & 1);
      const uint8_t* qs = smem + L::Q(s);
      const uint8_t* dos = smem + L::DO(s);
      const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE(s));
      const float* delta_s =
          reinterpret_cast<const float*>(smem + L::DELTA(s));

      float st[kTcBM / 2], dpt[kTcBM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kTcBM, 0, 0>::ss(st, desc_k<D, kTcBN>(ks, kk),
                             desc_k<D, kTcBM>(qs, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kTcBM, 0, 0>::ss(dpt, desc_k<D, kTcBN>(vs, kk),
                             desc_k<D, kTcBM>(dos, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                   // S^T is in; dP^T may still run
      fence_regs(st);

      // P^T = exp2(S^T scale log2e - lse log2e), zero where masked.
      const bool edge = q0 + kTcBM > sq || kvw + 64 > skv ||
                        (causal && q0 < kvw + 63);
#pragma unroll
      for (int j = 0; j < kTcBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col0 + e;
          const float l2 = lse_s[c] * kLog2e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p = exp2f(fmaf(st[4 * j + 2 * h + e], scale_log2, -l2));
            if (edge) {
              const int q = q0 + c, kv = kv0 + 8 * h;
              if (q >= sq || kv >= skv || (causal && q < kv)) p = 0.f;
            }
            st[4 * j + 2 * h + e] = p;
          }
        }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta) scale.
#pragma unroll
      for (int j = 0; j < kTcBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_s[8 * j + col0 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * j + 2 * h + e;
            dpt[x] = st[x] * (dpt[x] - dl) * scale;
          }
        }

      // The A fragments of the q-reduction: k16 step t takes the column
      // groups 2t and 2t + 1; P and dS round to bf16 here.
      uint32_t pa[kTcBM / 16][4], dsa[kTcBM / 16][4];
#pragma unroll
      for (int t = 0; t < kTcBM / 16; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 4 * (2 * t + r / 2) + 2 * (r % 2);
          pa[t][r] = pack_bf16(st[x], st[x + 1]);
          dsa[t][r] = pack_bf16(dpt[x], dpt[x + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kTcBM / 16; ++t)
        Mma<D, 0, 1>::rs(dvacc, pa[t], desc_mn<D, kTcBM>(dos, t), 1);
#pragma unroll
      for (int t = 0; t < kTcBM / 16; ++t)
        Mma<D, 0, 1>::rs(dkacc, dsa[t], desc_mn<D, kTcBM>(qs, t), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dvacc);
      fence_regs(dkacc);
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kv0 + 8 * h;
      if (row >= skv) continue;
      const int64_t off = (((int64_t)bi * skv + row) * hkv + hk) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int x = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + col0) =
            __floats2bfloat162_rn(dkacc[x], dkacc[x + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + col0) =
            __floats2bfloat162_rn(dvacc[x], dvacc[x + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int b, sq, skv, hq, hkv, causal;
  float scale;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BM - 1) / BM, a.hq, a.b);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, a.sq, a.skv, a.hq, a.hkv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + BN - 1) / BN, a.hkv, a.b);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.sq, a.skv, a.hq, a.hkv, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!hopper::map_bshd<D>(&qmap, a.q, a.b, a.sq, a.hq, kTcBM) ||
      !hopper::map_bshd<D>(&domap, a.dout, a.b, a.sq, a.hq, kTcBM) ||
      !hopper::map_bshd<D>(&kmap, a.k, a.b, a.skv, a.hkv, kTcBN) ||
      !hopper::map_bshd<D>(&vmap, a.v, a.b, a.skv, a.hkv, kTcBN))
    return cudaErrorInvalidValue;
  constexpr int smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hkv, a.b, (a.skv + kTcBN - 1) / kTcBN);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kTcThreads, smem, st>>>(
      qmap, kmap, vmap, domap, a.lse, a.delta, (__nv_bfloat16*)a.dk,
      (__nv_bfloat16*)a.dv, a.sq, a.skv, a.hq, a.hkv, a.causal, a.scale,
      a.scale * hopper::kLog2e);
  return cudaGetLastError();
}

// dQ: the FMA kernel in both dtypes.  dK/dV: the FMA kernel in f32, the
// wgmma kernel in bf16.
template <bool DQ, typename T, int D>
cudaError_t launch_one(const Args& a, cudaStream_t st) {
  if constexpr (DQ)
    return launch_dq<T, D>(a, st);
  else if constexpr (std::is_same<T, float>::value)
    return launch_dkv<T, D>(a, st);
  else
    return launch_dkv_wgmma<D>(a, st);
}

template <bool DQ, typename T>
cudaError_t launch_d(const Args& a, int d, cudaStream_t st) {
  switch (d) {
    case 32: return launch_one<DQ, T, 32>(a, st);
    case 64: return launch_one<DQ, T, 64>(a, st);
    case 128: return launch_one<DQ, T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(const Args& a, int d, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.b <= 0 || a.sq <= 0 || a.skv <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<DQ, float>(a, d, st);
  if (dtype == 1) return launch_d<DQ, __nv_bfloat16>(a, d, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int b, int sq,
                               int skv, int hq, int hkv, int d, int causal,
                               float sm_scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               b, sq, skv, hq, hkv, causal, sm_scale};
  return launch<true>(a, d, dtype, stream);
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int b,
                                int sq, int skv, int hq, int hkv, int d,
                                int causal, float sm_scale, int dtype,
                                void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               b, sq, skv, hq, hkv, causal, sm_scale};
  return launch<false>(a, d, dtype, stream);
}
