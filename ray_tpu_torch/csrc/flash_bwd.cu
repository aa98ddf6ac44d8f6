// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: ray_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (driven by _flash_bwd, the custom_vjp backward of flash_attention).  Same
// function: with P = exp(S * scale - lse) recomputed from the forward's f32
// lse and dS = P * (dO V^T - delta) * scale, where delta = rowsum(dO * O)
// comes in precomputed,
//   dQ = dS K                  (dS rounded to K's dtype first, as the
//                               Pallas kernel casts it before the product)
//   dV = sum over the n_rep q heads of P^T dO     (P and dS stay f32)
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
// Design (the simple, right version, like flash_fwd.cu): FMA loops over
// tiles staged in shared memory as f32, no tensor cores.
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
// gives the same bits every time, as the TPU kernels' grids do.  Tensor
// cores (mma / wgmma), TMA and a fused single-pass design are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

template <bool DQ, typename T>
cudaError_t launch_d(const Args& a, int d, cudaStream_t st) {
  switch (d) {
    case 32: return DQ ? launch_dq<T, 32>(a, st) : launch_dkv<T, 32>(a, st);
    case 64: return DQ ? launch_dq<T, 64>(a, st) : launch_dkv<T, 64>(a, st);
    case 128: return DQ ? launch_dq<T, 128>(a, st) : launch_dkv<T, 128>(a, st);
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
