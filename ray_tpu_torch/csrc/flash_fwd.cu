// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel (driven by
// _flash_fwd and flash_attention).  Same function: causal or non-causal GQA
// attention over q [b, sq, hq, d], k/v [b, skv, hkv, d] (the public layout,
// read in place -- no transposes), KV head hi / (hq / hkv), f32 online
// softmax, P cast to the value dtype before the PV product (as the Pallas
// kernel does), o in the input dtype plus the f32 lse [b, hq, sq] that the
// backward will read.  Fully masked rows return zeros.
//
// What bounds it: operations.  Causal prefill at Llama-3-8B widths (d 128,
// prompts of 512-1024) does ~s/2 * 4 flops per K/V byte, well above the
// ridge, so the kernel is compute-bound.
//
// Design (the simple, right version): one block of 256 threads per (q tile
// of 64 rows, q head, batch); the TPU's sequential KV grid axis becomes a
// loop over 64-row K/V tiles inside the block, which stops at the diagonal
// when causal.  Tiles are staged in shared memory as f32 and both products
// run as register-blocked FMA loops (4 rows x 4 cols of S, 4 rows x d/16
// cols of O per thread).  Rows and keys past the sequence end are
// zero-filled and masked, so any sequence length works -- the TPU's
// seq % 128 gate is gone.  The tensor cores (mma / wgmma) and TMA are later
// work; they are where the remaining factor lies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
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

// Stage `rows` rows (from row0, stride `rs` elements) of a [*, D] slice into
// shared memory as f32 with leading dimension LD; rows past `n` are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n, int64_t rs) {
  constexpr int VEC = VecN<T>::N;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += kThreads) {
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

template <int D>
constexpr int smem_bytes() {
  return (3 * BM * (D + 4) + BM * (BN + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int hq,
    int hkv, int causal, float scale) {
  constexpr int LD = D + 4;          // keeps float4 alignment, spreads banks
  constexpr int LDP = BN + 4;
  constexpr int CPT = D / 16;        // O columns per thread
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (hq / hkv);
  const int ty = threadIdx.x / 16;   // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;   // cols tx + 16*j
  const int64_t qrs = (int64_t)hq * D;
  const int64_t krs = (int64_t)hkv * D;
  const T* qb = q + ((int64_t)bi * sq * hq + hi) * D;
  const T* kb = k + ((int64_t)bi * skv * hkv + hk) * D;
  const T* vb = v + ((int64_t)bi * skv * hkv + hk) * D;

  stage<T, D, LD>(Qs, qb, q0, sq, qrs);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // Causal: K/V tiles above this q tile's last row are skipped entirely.
  const int kv_end = causal ? min(skv, q0 + BM) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();                 // previous tile's readers are done
    stage<T, D, LD>(Ks, kb, k0, skv, krs);
    stage<T, D, LD>(Vs, vb, k0, skv, krs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D; kd += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + kd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + kd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, bb[j].x, t);
          t = fmaf(a[i].y, bb[j].y, t);
          t = fmaf(a[i].z, bb[j].z, t);
          t = fmaf(a[i].w, bb[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= skv || (causal && col > row)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float ms = (mn == -INFINITY) ? 0.f : mn;
      const float alpha = expf(m[i] - ms);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - ms);
        ps += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LDP + n);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        const float v0 = Vs[(n + 0) * LD + col];
        const float v1 = Vs[(n + 1) * LD + col];
        const float v2 = Vs[(n + 2) * LD + col];
        const float v3 = Vs[(n + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][c];
          t = fmaf(p4[i].x, v0, t);
          t = fmaf(p4[i].y, v1, t);
          t = fmaf(p4[i].z, v2, t);
          t = fmaf(p4[i].w, v3, t);
          acc[i][c] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float L = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((int64_t)bi * sq + row) * qrs + (int64_t)hi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 16 * c, acc[i][c] / L);
    if (tx == 0) lse[((int64_t)bi * hq + hi) * sq + row] = m[i] + logf(L);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int sq, int skv, int hq, int hkv,
                     int causal, float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BM - 1) / BM, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, skv, hq, hkv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int skv, int hq, int hkv, int d,
                   int causal, float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch_d<T, 32>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                    causal, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                    causal, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                      causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int b, int sq, int skv,
                            int hq, int hkv, int d, int causal, float sm_scale,
                            int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, causal,
                         sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, hq, hkv, d,
                                 causal, sm_scale, st);
  return cudaErrorInvalidValue;
}
