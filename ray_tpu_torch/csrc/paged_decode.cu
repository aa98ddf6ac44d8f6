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
// ~295 flops/byte ridge, so the dot products stay FMA loops.  Reaching the
// memory rate takes several MB in flight across the card, so the design is
// about parallelism and loads in flight:
//
// Split-KV (flash-decoding) over a thread-block cluster.  Each (slot, kv
// head) gets a cluster of kSplits = 8 blocks: B * kvh * 8 blocks, 512 at
// Llama-3-8B batch 8, where one block per (slot, kv head) gave 64 blocks
// on 132 SMs.  The slot's admitted keys (page rows below the clamped
// tail_start, then tail rows tail_start + j <= pos) are numbered 0..n-1 on
// the device from pos and tail_start, and block c takes the c-th eighth of
// them, looping when a share is long (up to maxp * page + kt keys).  In a
// block a group of G lanes owns one key row at a time (G = hd / 8 for
// bf16, hd / 4 for f32; 16-byte loads), and every lane issues the K and V
// loads of kRows = 2 key rows before the dot products and one
// online-softmax update for both; the page-table reads of the next step go
// out before this step's arithmetic.  Held to 128 registers, four blocks
// share an SM (64 bytes in flight a lane, 32 KB an SM), so the 512 blocks
// of the 8B state run in one wave; more rows a lane, which costs
// registers and so blocks, or a cp.async ring in shared memory, which
// costs neither, measured no faster there.  All rep query heads share
// every row loaded.  Groups merge by shuffles, warps through shared
// memory, into one partial (m, l, acc[rep][hd]) in the block's shared
// memory.  After cluster.sync() each block merges a share of o's rep * hd
// values across the eight partials, in split order, read through
// distributed shared memory, and writes them once; a second cluster.sync()
// keeps every block's shared memory alive until the others have read it.
// One launch, no scratch in device memory, no atomics and no host read of
// pos or tail_start: a run gives the same bits every time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplits = 8;           // blocks a cluster = splits of the keys
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;             // rows whose loads a lane issues at once
constexpr int kBlocksPerSm = 4;      // the register cap: 128 a thread
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};

__device__ __forceinline__ void unpack(const float4& v, float* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void unpack(const uint4& v, float* out) {
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

// Weight of a partial with max `m` in a merge whose max is `mt` (log2
// units); an empty partial (m = -inf) weighs 0.
__device__ __forceinline__ float weight(float m, float mt) {
  return m == -INFINITY ? 0.f : exp2f(m - mt);
}

template <typename T, int HD, int REP>
__global__ void __cluster_dims__(kSplits, 1, 1)
    __launch_bounds__(kThreads, REP >= 8 ? 1 : kBlocksPerSm)
    paged_decode_split_kernel(
        const T* __restrict__ q, const T* __restrict__ kp,
        const T* __restrict__ vp, const T* __restrict__ ktl,
        const T* __restrict__ vtl, const int* __restrict__ table,
        const int* __restrict__ pos_a, const int* __restrict__ ts_a,
        T* __restrict__ o, int kvh, int page, int maxp, int kt,
        float scale_log2) {
  using Raw = typename Vec<T>::Raw;
  constexpr int VEC = Vec<T>::N;
  constexpr int G = HD / VEC;          // lanes that share one key row
  constexpr int KPW = 32 / G;          // key rows a warp covers at once
  constexpr int STEP = kWarps * kRows * KPW;  // keys a block step
  static_assert(G >= 1 && G <= 32 && 32 % G == 0, "bad head_dim");

  __shared__ float sm_m[kWarps][REP], sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][HD];
  __shared__ float part_m[REP], part_l[REP];    // this block's partial
  __shared__ float part_acc[REP][HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / kSplits;
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;
  const int gl = lane % G;

  // The admitted keys 0..n-1: n_page page rows, then n_tail tail rows.
  const int pos = pos_a[b];
  const int ts = ts_a[b];
  const int n_page = max(0, min(ts, maxp * page));
  const int n_tail = static_cast<int>(
      max((int64_t)0, min((int64_t)kt, (int64_t)pos - ts + 1)));
  const int n = n_page + n_tail;
  const int share = (n + kSplits - 1) / kSplits;
  const int beg = min(n, split * share);
  const int end = min(n, beg + share);

  // Where each key row this lane loads next lives: a page row through the
  // table, or a tail row.  Looked up a step ahead, so the table read
  // overlaps the previous step's K/V loads.
  int64_t off[kRows];
  bool in_page[kRows];
  auto locate = [&](int at) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int key = at + (warp * kRows + u) * KPW + grp;
      in_page[u] = key < n_page;
      if (in_page[u]) {
        const int i = key / page;
        const int64_t pid = table[(int64_t)b * maxp + i];
        off[u] = ((pid * kvh + h) * page + (key - i * page)) * HD;
      } else {
        off[u] = ((int64_t)bh * kt + (key - n_page)) * HD;
      }
      off[u] += gl * VEC;
    }
  };
  locate(beg);

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    unpack(*reinterpret_cast<const Raw*>(
               q + ((int64_t)bh * REP + r) * HD + gl * VEC),
           qv[r]);

  float m[REP], l[REP], acc[REP][VEC];   // m in log2 units
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // Every lane of the block runs the same steps, so the shuffles below
  // always see the full warp.
  for (int base = beg; base < end; base += STEP) {
    Raw kr[kRows], vr[kRows];
    bool valid[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      valid[u] = base + (warp * kRows + u) * KPW + grp < end;
      kr[u] = vr[u] = Raw{};
      if (valid[u]) {
        kr[u] = *reinterpret_cast<const Raw*>((in_page[u] ? kp : ktl) +
                                              off[u]);
        vr[u] = *reinterpret_cast<const Raw*>((in_page[u] ? vp : vtl) +
                                              off[u]);
      }
    }
    if (base + STEP < end) locate(base + STEP);

    float s[kRows][REP];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float kf[VEC];
      unpack(kr[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[r][e], kf[e], d);
        s[u][r] = d;
      }
    }
#pragma unroll
    for (int sh = G / 2; sh > 0; sh /= 2)
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], sh);

    // Online softmax over the kRows rows at once; s becomes P.
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][r] * scale_log2);
      const float mn = fmaxf(m[r], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[r] - ms);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        s[u][r] = valid[u] ? exp2f(fmaf(s[u][r], scale_log2, -ms)) : 0.f;
        ps += s[u][r];
      }
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float vf[VEC];
      unpack(vr[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[r][e] = fmaf(s[u][r], vf[e], acc[r][e]);
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
      const float a = weight(m[r], mn);
      const float c = weight(mo, mn);
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

  // Merge the warps into this block's partial.
  for (int t = threadIdx.x; t < REP * HD; t += kThreads) {
    const int r = t / HD;
    const int dd = t % HD;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(sm_m[w][r], mt);
      lt += sm_l[w][r] * c;
      at += sm_acc[w][r][dd] * c;
    }
    part_acc[r][dd] = at;
    if (dd == 0) {
      part_m[r] = mt;
      part_l[r] = lt;
    }
  }
  cluster.sync();

  // Merge the cluster's partials in split order, this block's share of o;
  // a slot with nothing admitted writes zeros.
  for (int t = split * kThreads + threadIdx.x; t < REP * HD;
       t += kSplits * kThreads) {
    const int r = t / HD;
    const int dd = t % HD;
    float pm[kSplits];
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < kSplits; ++c) {
      pm[c] = *cluster.map_shared_rank(&part_m[r], c);
      mt = fmaxf(mt, pm[c]);
    }
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int c = 0; c < kSplits; ++c) {
      const float w = weight(pm[c], mt);
      lt += *cluster.map_shared_rank(&part_l[r], c) * w;
      at += *cluster.map_shared_rank(&part_acc[r][dd], c) * w;
    }
    store(o + ((int64_t)bh * REP + r) * HD + dd, lt == 0.f ? 0.f : at / lt);
  }
  cluster.sync();                    // others may still read this block
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* kp, const void* vp,
                      const void* kt, const void* vt, const int* table,
                      const int* pos, const int* ts, void* o, int B, int kvh,
                      int rep, int page, int maxp, int ktail, float scale,
                      cudaStream_t st) {
  const dim3 grid(B * kvh * kSplits);
  const float scale_log2 = scale * kLog2e;
#define RT_PAGED_LAUNCH(R)                                                   \
  paged_decode_split_kernel<T, HD, R><<<grid, kThreads, 0, st>>>(            \
      (const T*)q, (const T*)kp, (const T*)vp, (const T*)kt, (const T*)vt,   \
      table, pos, ts, (T*)o, kvh, page, maxp, ktail, scale_log2)
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
