// Flash-attention forward for Hopper (sm_90a): a tensor-core kernel for
// bf16 and an FMA kernel for f32.
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel (driven by
// _flash_fwd and flash_attention).  Same function: causal or non-causal GQA
// attention over q [b, sq, hq, d], k/v [b, skv, hkv, d] (the public layout,
// read in place -- no transposes), KV head hi / (hq / hkv), f32 online
// softmax, P cast to the value dtype before the PV product (as the Pallas
// kernel does), o in the input dtype plus the f32 lse [b, hq, sq] that the
// backward will read.  Fully masked rows return zeros.  Any sequence length
// works (the TPU's seq % 128 gate is gone); head_dim 32, 64 or 128.
//
// What bounds it: operations.  Causal prefill at Llama-3-8B widths (d 128,
// prompts of 512-1024) does ~s/2 * 4 flops per K/V byte, well above the
// ridge of ~295 flops a byte in bf16, so the tensor cores are the limit.
//
// bf16 (flash_fwd_wgmma_kernel): one block per (128-row q tile, q head,
// batch), the heaviest causal tiles launched first.  Three roles:
//   - one producer warp keeps TMA loads in flight: the Q tile once, then
//     the K and V tiles (128 rows each) through a ring of two stages in
//     shared memory, each stage completing on a "full" mbarrier and handed
//     back on an "empty" one.  The 4-D tensor maps (d, h, s, b) return rows
//     past the sequence end as zeros, and swizzle each 128-byte row block
//     into the wgmma layout (hopper.cuh);
//   - two consumer warpgroups, 64 q rows each, run S = Q K^T as
//     wgmma m64n128k16 with both operands in shared memory, the online
//     softmax on the accumulator fragments (row max and sum over the four
//     lanes that share a row), and O += P V as wgmma with P from registers:
//     the S fragment, rescaled, rounded to bf16, is already the A-operand
//     layout; V is read MN-major.  The causal loop stops at the diagonal and
//     masks only the tiles that cross it or the sequence end.
// While one warpgroup runs its softmax the other's products keep the
// tensor cores busy, and the next stage's copy overlaps both.
//
// f32 (flash_fwd_kernel): the tensor cores would round f32 inputs to TF32,
// so f32 keeps the simple kernel: one block of 256 threads per (64-row q
// tile, q head, batch) looping over 64-row K/V tiles, staged in shared
// memory, both products as register-blocked FMA loops.
#include "hopper.cuh"

#include <math.h>

namespace {

// --------------------------------------------------------- f32: FMA loops
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kThreads = 256;

// Stage BM rows (from row0, stride `rs` elements) of a [*, D] slice into
// shared memory with leading dimension LD; rows past `n` are zeros.
template <int D, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n, int64_t rs) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        row0 + r < n ? *reinterpret_cast<const float4*>(
                           src + (int64_t)(row0 + r) * rs + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (3 * BM * (D + 4) + BM * (BN + 4)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int hq, int hkv, int causal,
    float scale) {
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
  const float* qb = q + ((int64_t)bi * sq * hq + hi) * D;
  const float* kb = k + ((int64_t)bi * skv * hkv + hk) * D;
  const float* vb = v + ((int64_t)bi * skv * hkv + hk) * D;

  stage<D, LD>(Qs, qb, q0, sq, qrs);

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
    stage<D, LD>(Ks, kb, k0, skv, krs);
    stage<D, LD>(Vs, vb, k0, skv, krs);
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
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
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
    float* orow = o + ((int64_t)bi * sq + row) * qrs + (int64_t)hi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] / L;
    if (tx == 0) lse[((int64_t)bi * hq + hi) * sq + row] = m[i] + logf(L);
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int sq, int skv, int hq, int hkv,
                       int causal, float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BM - 1) / BM, hq, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, sq,
      skv, hq, hkv, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16: wgmma and TMA
constexpr int kTcBM = 128;             // q rows a block: two warpgroups
constexpr int kTcBN = 128;             // K/V rows a stage
constexpr int kTcStages = 2;
constexpr int kTcThreads = 288;        // two consumer warpgroups + a producer
constexpr int kTcArrivals = 8;         // consumer warps releasing a stage

template <int D>
struct FwdSmem {
  static constexpr int Q = kTcBM * D * 2;
  static constexpr int KV = kTcBN * D * 2;
  __host__ __device__ static constexpr int K(int s) {
    return Q + s * 2 * KV;
  }
  __host__ __device__ static constexpr int V(int s) {
    return K(s) + KV;
  }
  static constexpr int BARS = Q + kTcStages * 2 * KV;
  // Barriers (q_full, full[], empty[]) and the 1024-byte alignment slack.
  static constexpr int BYTES = BARS + 8 * (1 + 2 * kTcStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int hq, int hkv, int causal,
    float scale_log2) {
  using namespace hopper;
  using L = FwdSmem<D>;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* smem = align1024(tc_smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBM;  // heaviest first
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int hk = hi / (hq / hkv);
  const int kv_end = causal ? min(skv, q0 + kTcBM) : skv;
  const int n_kv = (kv_end + kTcBN - 1) / kTcBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {                       // the producer warp
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::Q);
      tma_tile<D, kTcBM>(smem, &qmap, q_full, hi, q0, bi);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages) mbar_wait(&empty[s], (i / kTcStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::KV);
        tma_tile<D, kTcBN>(smem + L::K(s), &kmap, &full[s], hk, i * kTcBN,
                           bi);
        tma_tile<D, kTcBN>(smem + L::V(s), &vmap, &full[s], hk, i * kTcBN,
                           bi);
      }
    }
    return;
  }

  // Consumer warpgroup wg: q rows q0 + 64 wg + r and + 8 of its
  // accumulator layout, r = 16 warp + lane / 4.
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint8_t* qs = smem + wg * 64 * Cols<D>::RB;   // this warpgroup's rows

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kTcStages;
    const int k0 = i * kTcBN;
    mbar_wait(&full[s], (i / kTcStages) & 1);
    const uint8_t* ks = smem + L::K(s);
    const uint8_t* vs = smem + L::V(s);

    float sacc[kTcBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kTcBN, 0, 0>::ss(sacc, desc_k<D, kTcBM>(qs, kk),
                           desc_k<D, kTcBN>(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // Mask keys past the end and, causal, past the diagonal: only in the
    // tiles that reach them.
    if (k0 + kTcBN > skv ||
        (causal && k0 + kTcBN - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + col0 + e;
            if (col >= skv || (causal && col > row0 + 8 * h))
              sacc[4 * j + 2 * h + e] = -INFINITY;
          }
    }

    float ms[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx * scale_log2);
      ms[h] = mn == -INFINITY ? 0.f : mn;
      alpha[h] = exp2f(m[h] - ms[h]);
      m[h] = mn;
    }

    // P = exp2(S scale log2e - m), summed unrounded, then rounded to bf16
    // into the A fragments of P V: the k16 step t takes the accumulator's
    // column groups 2t and 2t + 1.
    uint32_t pa[kTcBN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kTcBN / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 2 * t + r / 2, h = r % 2;
        const float p0 = exp2f(fmaf(sacc[4 * j + 2 * h], scale_log2, -ms[h]));
        const float p1 =
            exp2f(fmaf(sacc[4 * j + 2 * h + 1], scale_log2, -ms[h]));
        rs[h] += p0 + p1;
        pa[t][r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        oacc[4 * j + 2 * h] *= alpha[h];
        oacc[4 * j + 2 * h + 1] *= alpha[h];
      }

    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTcBN / 16; ++t)
      Mma<D, 0, 1>::rs(oacc, pa[t], desc_mn<D, kTcBN>(vs, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float L_ = sum == 0.f ? 1.f : sum;
    const float inv = 1.f / L_;
    __nv_bfloat16* orow = o + (((int64_t)bi * sq + row) * hq + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * h] * inv,
                                oacc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[((int64_t)bi * hq + hi) * sq + row] =
          (m[h] == -INFINITY ? 0.f : m[h] * kLn2) + logf(L_);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int b, int sq, int skv, int hq, int hkv,
                         int causal, float scale, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::map_bshd<D>(&qmap, q, b, sq, hq, kTcBM) ||
      !hopper::map_bshd<D>(&kmap, k, b, skv, hkv, kTcBN) ||
      !hopper::map_bshd<D>(&vmap, v, b, skv, hkv, kTcBN))
    return cudaErrorInvalidValue;
  constexpr int smem = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, b, (sq + kTcBM - 1) / kTcBM);
  flash_fwd_wgmma_kernel<D><<<grid, kTcThreads, smem, st>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, lse, sq, skv, hq, hkv, causal,
      scale * hopper::kLog2e);
  return cudaGetLastError();
}

// dtype 0 (float32) takes the FMA kernel, 1 (bfloat16) the wgmma kernel.
template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v,
                     void* o, float* lse, int b, int sq, int skv, int hq,
                     int hkv, int causal, float scale, cudaStream_t st) {
  return dtype == 0 ? launch_fma<D>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                    causal, scale, st)
                    : launch_wgmma<D>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                      causal, scale, st);
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the wgmma kernel).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int b, int sq, int skv,
                            int hq, int hkv, int d, int causal, float sm_scale,
                            int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_d<32>(dtype, q, k, v, o, lse, b, sq, skv, hq, hkv,
                                 causal, sm_scale, st);
    case 64: return launch_d<64>(dtype, q, k, v, o, lse, b, sq, skv, hq, hkv,
                                 causal, sm_scale, st);
    case 128: return launch_d<128>(dtype, q, k, v, o, lse, b, sq, skv, hq,
                                   hkv, causal, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}
