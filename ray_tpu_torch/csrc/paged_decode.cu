// Paged + tail decode attention for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py::_kernel (the Pallas TPU kernel
// behind paged_decode_attention).  Same function: single-token GQA decode
// over a shared page pool [n_pages, kvh, page, hd] read through a page table
// (rows < tail_start) plus a dense per-slot tail [B, kvh, kt, hd] (rows
// tail_start + j <= pos), with one f32 online softmax over both.  P stays
// f32 before the PV product, as in the reference.  A slot with nothing
// admitted returns zeros.  The page count is clamped to maxp * page, so a
// runaway idle slot never indexes past its table row.
//
// What bounds it: bytes.  Every admitted K/V row is read once and used for
// `rep` query heads, about 2 * rep flops per byte -- far below the card's
// ~295 flops/byte ridge.
//
// Design: one block per (slot, kv-head); the TPU's sequential page grid
// axis becomes a loop inside the block.  A group of G lanes owns one key
// row at a time and loads it with 16-byte vector loads (G = hd / 8 for
// bf16, hd / 4 for f32); the group's `rep` dot products reduce with a few
// shuffles, and all rep query heads of the group share every K/V row
// loaded.  Each group keeps its own online-softmax state; groups merge by
// shuffles, warps through shared memory.  This is the simple, right
// version: with B * kvh blocks (64 at Llama-3-8B, batch 8) most SMs sit
// idle, and splitting the pages over blocks (flash-decoding) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const T* __restrict__ ktl,
    const T* __restrict__ vtl, const int* __restrict__ table,
    const int* __restrict__ pos_a, const int* __restrict__ ts_a,
    T* __restrict__ o, int kvh, int page, int maxp, int kt, float scale) {
  constexpr int VEC = VecN<T>::N;
  constexpr int G = HD / VEC;        // lanes that share one key row
  constexpr int KPW = 32 / G;        // key rows per warp per step
  static_assert(G >= 1 && G <= 32 && 32 % G == 0, "bad head_dim");

  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][HD];

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;
  const int gl = lane % G;

  const int pos = pos_a[b];
  const int ts = ts_a[b];
  const int ts_c = max(0, min(ts, maxp * page));
  const int n_page_keys = ((ts_c + page - 1) / page) * page;
  const int n_keys = n_page_keys + kt;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    load_vec(q + ((int64_t)(b * kvh + h) * REP + r) * HD + gl * VEC, qv[r]);

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // Every group of a warp runs the same number of steps, so the shuffles
  // below always see the full warp.
  for (int base = warp * KPW; base < n_keys; base += kWarps * KPW) {
    const int key = base + grp;
    bool valid = false;
    const T* krow = nullptr;
    const T* vrow = nullptr;
    if (key < n_page_keys) {
      const int i = key / page;
      const int r = key - i * page;
      const int64_t pid = table[(int64_t)b * maxp + i];
      const int64_t off = ((pid * kvh + h) * page + r) * HD;
      krow = kp + off;
      vrow = vp + off;
      valid = key < ts;              // rows >= tail_start live in the tail
    } else if (key < n_keys) {
      const int j = key - n_page_keys;
      const int64_t off = (((int64_t)b * kvh + h) * kt + j) * HD;
      krow = ktl + off;
      vrow = vtl + off;
      valid = (int64_t)ts + j <= pos;
    }
    float kf[VEC], vf[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
    if (valid) {
      load_vec(krow + gl * VEC, kf);
      load_vec(vrow + gl * VEC, vf);
    }
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) d = fmaf(qv[r][e], kf[e], d);
      s[r] = d;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
#pragma unroll
      for (int r = 0; r < REP; ++r)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    if (valid) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float sr = s[r] * scale;
        const float mn = fmaxf(m[r], sr);
        const float alpha = expf(m[r] - mn);
        const float p = expf(sr - mn);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * alpha);
        m[r] = mn;
      }
    }
  }

  // Merge the groups of each warp (their lanes differ in bits >= log2 G).
#pragma unroll
  for (int off = G; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float a = (m[r] == -INFINITY) ? 0.f : expf(m[r] - mn);
      const float c = (mo == -INFINITY) ? 0.f : expf(mo - mn);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * c;
      }
      m[r] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][r][gl * VEC + e] = acc[r][e];
      if (gl == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // Merge the warps; a slot with nothing admitted writes zeros.
  for (int t = threadIdx.x; t < REP * HD; t += kThreads) {
    const int r = t / HD;
    const int dd = t % HD;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][r]);
    float lt = 0.f, at = 0.f;
    if (mt != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w][r];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - mt);
        lt += sm_l[w][r] * c;
        at += sm_acc[w][r][dd] * c;
      }
    }
    const float out = lt == 0.f ? 0.f : at / lt;
    store(o + ((int64_t)(b * kvh + h) * REP + r) * HD + dd, out);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* kp, const void* vp,
                      const void* kt, const void* vt, const int* table,
                      const int* pos, const int* ts, void* o, int B, int kvh,
                      int rep, int page, int maxp, int ktail, float scale,
                      cudaStream_t st) {
  const dim3 grid(B * kvh);
#define RT_PAGED_LAUNCH(R)                                                   \
  paged_decode_kernel<T, HD, R><<<grid, kThreads, 0, st>>>(                  \
      (const T*)q, (const T*)kp, (const T*)vp, (const T*)kt, (const T*)vt,   \
      table, pos, ts, (T*)o, kvh, page, maxp, ktail, scale)
  switch (rep) {
    case 1: RT_PAGED_LAUNCH(1); break;
    case 2: RT_PAGED_LAUNCH(2); break;
    case 4: RT_PAGED_LAUNCH(4); break;
    case 8: RT_PAGED_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef RT_PAGED_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* kt, const void* vt, const int* table,
                   const int* pos, const int* ts, void* o, int B, int kvh,
                   int rep, int hd, int page, int maxp, int ktail, float scale,
                   cudaStream_t st) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, kp, vp, kt, vt, table, pos, ts, o, B,
                                     kvh, rep, page, maxp, ktail, scale, st);
    case 64: return launch_hd<T, 64>(q, kp, vp, kt, vt, table, pos, ts, o, B,
                                     kvh, rep, page, maxp, ktail, scale, st);
    case 128: return launch_hd<T, 128>(q, kp, vp, kt, vt, table, pos, ts, o,
                                       B, kvh, rep, page, maxp, ktail, scale,
                                       st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int rt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_tail,
                               const void* v_tail, const int* page_table,
                               const int* pos, const int* tail_start, void* o,
                               int B, int kvh, int rep, int hd, int page,
                               int maxp, int ktail, float sm_scale, int dtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || kvh <= 0 || page <= 0 || maxp <= 0 || ktail < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, k_tail, v_tail, page_table, pos,
                         tail_start, o, B, kvh, rep, hd, page, maxp, ktail,
                         sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, k_tail, v_tail,
                                 page_table, pos, tail_start, o, B, kvh, rep,
                                 hd, page, maxp, ktail, sm_scale, st);
  return cudaErrorInvalidValue;
}
