// Fused SE-ResNet stage for Hopper (sm_90a): N stride-1 SEBasicBlocks in
// eval mode, NHWC, C = 128.
//
// Replaces the TPU kernel emotiongestures_tpu/ops/pallas_se_block.py
// (_stage_kernel, driven by fused_se_stage). Per block, with BatchNorm folded
// to per-channel affines (s, t) outside the kernel:
//
//     y    = T(relu(conv3x3(x, w1)) * s1 + t1)        (the reference's
//                                                       conv -> relu -> bn)
//     z    = conv3x3(y, w2) * s2 + t2                  (fp32)
//     gate = sigmoid(T(relu(T(mean_hw z) @ f1w + f1b)) @ f2w + f2b)
//     x    = T(relu(z * gate + x))
//
// T is x's type (fp32 or bf16): products of T values accumulate in fp32, and
// bn1's output, the SE fc inputs and the block output are rounded to T, the
// TPU kernel's dtype flow. fp32 products run as fp32 FMA (TF32 would miss the
// 2e-5 tolerance of the fp32 stage); bf16 products run on the tensor cores
// with mma.sync m16n8k16 and fp32 accumulation, which is the TPU's math
// (bf16 products summed in fp32).
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. At B = 1024,
// 32 x 31, C = 128, NB = 5 the ten convolutions are 2 * 1024 * 992 * 1152 *
// 128 * 10 ~ 3.0 TFLOP, ~45 ms at 67 TFLOP/s of fp32 FMA (~3.0 ms at the
// 989 TFLOP/s bf16 tensor-core peak), against ~1 GB of x, output and weights.
//
// Design (simple first version, 3 launches per block): one sample's
// activation (508 KB in fp32) does not fit an SM's 227 KB of shared memory,
// and the SE gate needs the whole block's mean before any output is final,
// so the TPU's stage-resident design does not carry over.
//   1. conv3x3_kernel<mode 0>: implicit GEMM, a block per 128 output pixels
//      of one sample x all 128 channels, K = 9 taps x 128 input channels in
//      steps of 16; the 1-pixel halo is gathered from global memory (zero
//      outside the image); relu + folded bn1 in the epilogue, stored as T.
//   2. conv3x3_kernel<mode 1>: the same for conv2, folded bn2 in the
//      epilogue, z stored fp32, and per (sample, tile, channel) sums of z
//      for the pool (a fixed-order reduction, no atomics).
//   3. se_gate_kernel: each block recomputes its sample's gate from the
//      partial sums (two tiny fcs), then z * gate + residual, relu, to T.
// Intermediates live in device memory / L2. In fp32 each thread of a conv
// block holds an 8 x 8 register tile of outputs fed from shared-memory tiles;
// in bf16 (conv3x3_mma_kernel) each warp holds a 64 x 32 tile of mma
// accumulators fed by ldmatrix. Both stage the next step's global loads in
// registers; neither uses wgmma, TMA or a multi-stage pipeline yet.
//
// C interface (loaded with ctypes): eg_se_stage(...) returns the
// cudaGetLastError() code after its launches; 0 means they launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 128;          // channels; the N tile is all of them
constexpr int kBM = 128;         // output pixels per block, of one sample
constexpr int kBK = 16;          // input channels per k step
constexpr int kStepsPerTap = kC / kBK;
constexpr int kSteps = 9 * kStepsPerTap;
constexpr int kMaxHidden = 64;   // SE bottleneck width (C / 8 = 16 here)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T and back: the TPU kernel's .astype(compute dtype)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// register tile row i -> pixel of the block's tile, col j -> channel
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// The fp32 conv. kMode 0: out_t = relu(conv) * scale + shift;
// kMode 1: out_f = conv * scale + shift, and partial[b][tile][c] = the sum
// of out_f over the tile's pixels
template <int kMode>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out_t,
               float* __restrict__ out_f, float* __restrict__ partial,
               int H, int W) {
  __shared__ __align__(16) float As[kBK][kBM];  // pixels, k-major
  __shared__ __align__(16) float Bs[kBK][kC];   // weights, k-major
  __shared__ float red[16][kC];                 // mode 1: column sums

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int HW = H * W;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kBM;
  const float* xb = x + (size_t)b * HW * kC;

  // A loader: pixels ar and ar + 64 of the tile, channels ak..ak+3 of a step
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  int ph[2], pw[2];
  bool pin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + ar + 64 * h;
    pin[h] = p < HW;
    ph[h] = pin[h] ? p / W : 0;
    pw[h] = pin[h] ? p % W : 0;
  }
  // B loader: input-channel rows bk and bk + 8, output channels bn..bn+3
  const int bk = tid >> 5, bn = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra[2], rb[2];
  auto gload = [&](int step) {
    const int tap = step / kStepsPerTap;
    const int c0 = (step % kStepsPerTap) * kBK;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hh = ph[h] + dh, ww = pw[h] + dw;
      const bool ok = pin[h] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      ra[h] = ok ? load4(xb + ((size_t)hh * W + ww) * kC + c0 + ak)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float* wt = w + ((size_t)tap * kC + c0) * kC;
    rb[0] = load4(wt + (size_t)bk * kC + bn);
    rb[1] = load4(wt + (size_t)(bk + 8) * kC + bn);
  };

  gload(0);
  for (int step = 0; step < kSteps; ++step) {
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ar + 64 * h;
      As[ak + 0][r] = ra[h].x;
      As[ak + 1][r] = ra[h].y;
      As[ak + 2][r] = ra[h].z;
      As[ak + 3][r] = ra[h].w;
    }
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = rb[0];
    *reinterpret_cast<float4*>(&Bs[bk + 8][bn]) = rb[1];
    __syncthreads();
    if (step + 1 < kSteps) gload(step + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }

  float sc[8], sh[8], colsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = tile_col(tx, j);
    sc[j] = scale[col];
    sh[j] = shift[col];
    colsum[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + tile_row(ty, i);
    if (p >= HW) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kMode == 0) {
        v[j] = fmaxf(acc[i][j], 0.f) * sc[j] + sh[j];
      } else {
        v[j] = acc[i][j] * sc[j] + sh[j];
        colsum[j] += v[j];
      }
    }
    const size_t base = ((size_t)b * HW + p) * kC;
    const float4 lo = make_float4(v[0], v[1], v[2], v[3]);
    const float4 hi = make_float4(v[4], v[5], v[6], v[7]);
    if (kMode == 0) {
      store4(out_t + base + tx * 4, lo);
      store4(out_t + base + 64 + tx * 4, hi);
    } else {
      store4(out_f + base + tx * 4, lo);
      store4(out_f + base + 64 + tx * 4, hi);
    }
  }
  if (kMode == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty][tile_col(tx, j)] = colsum[j];
    __syncthreads();
    if (tid < kC) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) s += red[t][tid];
      partial[((size_t)b * gridDim.x + blockIdx.x) * kC + tid] = s;
    }
  }
}

constexpr int kMK = 32;          // input channels per k step (bf16 mma)
constexpr int kLdA = kMK + 8;    // padded rows: ldmatrix without conflicts
constexpr int kLdB = kC + 8;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 form of conv3x3_kernel (same modes, same block tile of 128
// pixels x 128 channels): the products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Eight warps as 2 (pixels) x
// 4 (channels), each a 64 x 32 tile of 4 x 4 mma tiles; shared-memory tiles
// of 32 input channels, read with ldmatrix from rows padded by 16 bytes.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   __nv_bfloat16* __restrict__ out_t,
                   float* __restrict__ out_f, float* __restrict__ partial,
                   int H, int W) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kLdA];  // [pixel][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kMK * kLdB];  // [k][channel]
  __shared__ float red[2][kC];                            // mode 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int HW = H * W;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kBM;
  const __nv_bfloat16* xb = x + (size_t)b * HW * kC;

  // A loader: 16-byte chunks tid and tid + 256 = (pixel, 8 channels);
  // B loader: the same chunks over (k row, 8 output channels)
  int apix[2], apart[2], ph[2], pw[2], brow[2], bpart[2];
  bool pin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tid + kThreads * h;
    apix[h] = c >> 2;
    apart[h] = c & 3;
    const int p = p0 + apix[h];
    pin[h] = p < HW;
    ph[h] = pin[h] ? p / W : 0;
    pw[h] = pin[h] ? p % W : 0;
    brow[h] = c >> 4;
    bpart[h] = c & 15;
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  constexpr int kMSteps = kC / kMK;
  uint4 ra[2], rb[2];
  auto gload = [&](int step) {
    const int tap = step / kMSteps;
    const int c0 = (step % kMSteps) * kMK;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hh = ph[h] + dh, ww = pw[h] + dw;
      const bool ok = pin[h] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      ra[h] = ok ? *reinterpret_cast<const uint4*>(
                       xb + ((size_t)hh * W + ww) * kC + c0 + apart[h] * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
      rb[h] = *reinterpret_cast<const uint4*>(
          w + ((size_t)tap * kC + c0 + brow[h]) * kC + bpart[h] * 8);
    }
  };

  gload(0);
  for (int step = 0; step < 9 * kMSteps; ++step) {
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint4*>(&As[apix[h] * kLdA + apart[h] * 8]) = ra[h];
      *reinterpret_cast<uint4*>(&Bs[brow[h] * kLdB + bpart[h] * 8]) = rb[h];
    }
    __syncthreads();
    if (step + 1 < 9 * kMSteps) gload(step + 1);
#pragma unroll
    for (int kk = 0; kk < kMK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], &As[(wm * 64 + mi * 16 + (lane & 15)) * kLdA + kk +
                            (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[(kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                             wn * 32 + nj * 16 + (lane >> 4) * 8]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

  // accumulator (mi, ni, e): pixel wm*64 + mi*16 + g (+8 for e >= 2),
  // channel wn*32 + ni*8 + 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  float sc[4][2], sh[4][2], colsum[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * 32 + ni * 8 + 2 * t + e;
      sc[ni][e] = scale[col];
      sh[ni][e] = shift[col];
      colsum[ni][e] = 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 64 + mi * 16 + g + half * 8;
      if (p >= HW) continue;
      const size_t base = ((size_t)b * HW + p) * kC;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + 2 * t;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (kMode == 0) {
          v0 = fmaxf(v0, 0.f) * sc[ni][0] + sh[ni][0];
          v1 = fmaxf(v1, 0.f) * sc[ni][1] + sh[ni][1];
          *reinterpret_cast<__nv_bfloat162*>(out_t + base + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          v0 = v0 * sc[ni][0] + sh[ni][0];
          v1 = v1 * sc[ni][1] + sh[ni][1];
          colsum[ni][0] += v0;
          colsum[ni][1] += v1;
          *reinterpret_cast<float2*>(out_f + base + col) = make_float2(v0, v1);
        }
      }
    }
  if (kMode == 1) {
    // sum over the 8 lanes that share t (lane bits 2-4), then the 2 warps
    // that share wn, in a fixed order
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = colsum[ni][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) red[wm][wn * 32 + ni * 8 + 2 * t + e] = s;
      }
    __syncthreads();
    if (tid < kC)
      partial[((size_t)b * gridDim.x + blockIdx.x) * kC + tid] =
          red[0][tid] + red[1][tid];
  }
}

// One block per (pixel tile, sample): the sample's SE gate from the conv2
// kernel's partial sums, then out = T(relu(z * gate + res)) over the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
se_gate_kernel(const float* __restrict__ z, const T* __restrict__ res,
               const float* __restrict__ partial, int HW,
               const T* __restrict__ f1w, const float* __restrict__ f1b,
               const T* __restrict__ f2w, const float* __restrict__ f2b,
               int hidden, T* __restrict__ out) {
  __shared__ float pool[kC];
  __shared__ float hid[kMaxHidden];
  __shared__ __align__(16) float gate[kC];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = gridDim.x;
  if (tid < kC) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t)
      s += partial[((size_t)b * n_tiles + t) * kC + tid];
    pool[tid] = round_to<T>(s / (float)HW);
  }
  __syncthreads();
  // fc1: warp w takes hidden units w, w + 8, ...; lanes split the channels
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = warp; j < hidden; j += kThreads / 32) {
    float s = 0.f;
#pragma unroll
    for (int c = lane; c < kC; c += 32)
      s = fmaf(pool[c], to_float(f1w[(size_t)c * hidden + j]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) hid[j] = round_to<T>(fmaxf(s + f1b[j], 0.f));
  }
  __syncthreads();
  if (tid < kC) {
    float s = 0.f;
    for (int j = 0; j < hidden; ++j)
      s = fmaf(hid[j], to_float(f2w[(size_t)j * kC + tid]), s);
    gate[tid] = 1.f / (1.f + expf(-(s + f2b[tid])));
  }
  __syncthreads();

  const int p0 = blockIdx.x * kBM;
  const int p1 = min(p0 + kBM, HW);
  const size_t base = ((size_t)b * HW + p0) * kC;
  const int n4 = (p1 - p0) * (kC / 4);
  for (int q = tid; q < n4; q += kThreads) {
    const size_t e = base + (size_t)q * 4;
    const int c = (q * 4) % kC;
    const float4 zv = *reinterpret_cast<const float4*>(z + e);
    const float4 rv = load4(res + e);
    const float4 g = *reinterpret_cast<const float4*>(&gate[c]);
    store4(out + e, make_float4(fmaxf(zv.x * g.x + rv.x, 0.f),
                                fmaxf(zv.y * g.y + rv.y, 0.f),
                                fmaxf(zv.z * g.z + rv.z, 0.f),
                                fmaxf(zv.w * g.w + rv.w, 0.f)));
  }
}

template <typename T>
int run_stage(const void* x_, void* out_, void* tmp_, void* y1_, void* z_,
              void* partial_, const void* w1_, const void* s1_,
              const void* t1_, const void* w2_, const void* s2_,
              const void* t2_, const void* f1w_, const void* f1b_,
              const void* f2w_, const void* f2b_, int B, int H, int W,
              int NB, int hidden, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  T* tmp = static_cast<T*>(tmp_);
  T* y1 = static_cast<T*>(y1_);
  float* z = static_cast<float*>(z_);
  float* partial = static_cast<float*>(partial_);
  const T* w1 = static_cast<const T*>(w1_);
  const T* w2 = static_cast<const T*>(w2_);
  const T* f1w = static_cast<const T*>(f1w_);
  const T* f2w = static_cast<const T*>(f2w_);
  const float* s1 = static_cast<const float*>(s1_);
  const float* t1 = static_cast<const float*>(t1_);
  const float* s2 = static_cast<const float*>(s2_);
  const float* t2 = static_cast<const float*>(t2_);
  const float* f1b = static_cast<const float*>(f1b_);
  const float* f2b = static_cast<const float*>(f2b_);

  const int HW = H * W;
  const dim3 grid((HW + kBM - 1) / kBM, B);
  const size_t wsize = (size_t)9 * kC * kC;
  const T* cur = x;
  for (int i = 0; i < NB; ++i) {
    // the last block writes `out`; blocks alternate between out and tmp,
    // so no block reads what it writes
    T* dst = ((NB - 1 - i) % 2 == 0) ? out : tmp;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      conv3x3_mma_kernel<0><<<grid, kThreads, 0, stream>>>(
          cur, w1 + i * wsize, s1 + i * kC, t1 + i * kC, y1, nullptr,
          nullptr, H, W);
      conv3x3_mma_kernel<1><<<grid, kThreads, 0, stream>>>(
          y1, w2 + i * wsize, s2 + i * kC, t2 + i * kC, nullptr, z, partial,
          H, W);
    } else {
      conv3x3_kernel<0><<<grid, kThreads, 0, stream>>>(
          cur, w1 + i * wsize, s1 + i * kC, t1 + i * kC, y1, nullptr,
          nullptr, H, W);
      conv3x3_kernel<1><<<grid, kThreads, 0, stream>>>(
          y1, w2 + i * wsize, s2 + i * kC, t2 + i * kC, nullptr, z, partial,
          H, W);
    }
    se_gate_kernel<T><<<grid, kThreads, 0, stream>>>(
        z, cur, partial, HW, f1w + (size_t)i * kC * hidden, f1b + i * hidden,
        f2w + (size_t)i * hidden * kC, f2b + i * kC, hidden, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = dst;
  }
  return 0;
}

}  // namespace

// x, out, tmp, y1: (B, H, W, 128) of the compute type (dtype 0 fp32, 1 bf16);
// z: (B, H, W, 128) fp32; partial: (B, ceil(H*W / 128), 128) fp32;
// w1, w2: (NB, 3, 3, 128, 128) HWIO and f1w (NB, 128, hidden), f2w
// (NB, hidden, 128) of the compute type; s1, t1, s2, t2, f2b (NB, 128) and
// f1b (NB, hidden) fp32. tmp is unused when NB == 1. All contiguous.
extern "C" int eg_se_stage(const void* x, int dtype, void* out, void* tmp,
                           void* y1, void* z, void* partial, const void* w1,
                           const void* s1, const void* t1, const void* w2,
                           const void* s2, const void* t2, const void* f1w,
                           const void* f1b, const void* f2w, const void* f2b,
                           int B, int H, int W, int C, int NB, int hidden,
                           void* stream) {
  if (C != kC || hidden < 1 || hidden > kMaxHidden || B < 1 || B > 65535 ||
      H < 1 || W < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_stage<float>(x, out, tmp, y1, z, partial, w1, s1, t1, w2, s2,
                            t2, f1w, f1b, f2w, f2b, B, H, W, NB, hidden, st);
  if (dtype == 1)
    return run_stage<__nv_bfloat16>(x, out, tmp, y1, z, partial, w1, s1, t1,
                                    w2, s2, t2, f1w, f1b, f2w, f2b, B, H, W,
                                    NB, hidden, st);
  return (int)cudaErrorInvalidValue;
}
