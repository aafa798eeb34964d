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
// with wgmma (bf16 in, fp32 accumulate), which is the TPU's math.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. At B = 1024,
// 32 x 31, C = 128, NB = 5 the ten convolutions are 2 * 1024 * 992 * 1152 *
// 128 * 10 ~ 3.0 TFLOP: ~45 ms at 67 TFLOP/s of fp32 FMA, ~3.0 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against ~0.5 GB of x and output.
//
// bf16 (se_stage_cluster_kernel): the whole stage in one launch, the TPU
// kernel's own design of keeping a sample's activations on chip across all
// blocks. One sample (254 KB at 32 x 31) does not fit one SM, so a thread-
// block cluster of n <= 8 CTAs holds it: each CTA owns R whole image rows
// (R = min(H, 128 / W), n = ceil(H / R); 4 rows, 124 of 128 GEMM rows used,
// and n = 8 at 32 x 31) and keeps two haloed bf16 tiles of (R+2) x (W+2) x
// 128 in shared memory: the block input (also the residual) and y; the
// image edges are zero. Each conv is 9 taps x 128 input channels, run as
// wgmma m64n128k16 on two consumer warpgroups (M = 128 rows). A comes from
// registers: ldmatrix at per-lane pixel addresses of the tile (a shifted tap
// window is no matrix a shared-memory descriptor can describe), the tile's
// 16-byte chunks XOR-swizzled by pixel so ldmatrix is conflict-free. B, the
// weight tiles (128 output x 64 input channels, repacked K-major by the
// wrapper), stream through a ring of 4 slots by TMA (128-byte swizzle) with
// full/empty mbarriers, filled by one producer warp; each CTA loads 1/n of a
// tile and multicasts it to the whole cluster, so the cluster reads the
// weights from L2 once, and a slot is refilled only after every CTA's
// consumers released it (remote mbarrier arrives). The centre-row taps run
// first: they read no halo row, and meanwhile three halo warps copy the
// neighbouring CTAs' edge rows over DSMEM (after the cluster barrier that
// follows their writes) and signal an mbarrier. Epilogues stay in
// registers: conv1's relu + bn1 goes to the y tile as bf16; conv2's bn2
// leaves z in the accumulators, which never reach memory. The pool sums z's
// columns per CTA in a fixed order, then after a cluster barrier every CTA
// adds the cluster's partials in rank order (the same sum everywhere); the
// two tiny SE fcs run on the CUDA cores, and relu(z * gate + x) is written
// over the input tile for the next block. Device memory sees the first
// input and the last output only (2 x 0.26 GB at B = 1024).
//
// What bounds it (tools/se_stage_breakdown.py's phase clock, H100 SXM): a
// conv's 18 k-tiles run at ~90% of the tensor cores' rate, but per block
// the serial phases between them (epilogues, the pool's cluster barrier
// and DSMEM sum, the SE fcs, the next block's set-up) take ~14k cycles
// beside ~22k of convs, with the tensor cores idle: the gate needs the
// whole sample's pool before any output, and a second sample per SM to
// fill the gaps does not fit in shared memory at 32 x 31.
//
// fp32 (3 launches per block): one sample's fp32 activation (508 KB) would
// need a cluster of 16, so the fp32 stage goes through device memory / L2.
//   1. conv3x3_kernel<mode 0>: implicit GEMM, a block per 128 output pixels
//      of one sample x all 128 channels, K = 9 taps x 128 input channels in
//      steps of 16, the 1-pixel halo gathered from global memory; relu +
//      folded bn1 in the epilogue. Each thread holds an 8 x 8 register tile
//      of outputs fed from shared-memory tiles.
//   2. conv3x3_kernel<mode 1>: the same for conv2, folded bn2 in the
//      epilogue, z stored fp32, and per (sample, tile, channel) sums of z
//      for the pool (a fixed-order reduction, no atomics).
//   3. se_gate_kernel: each block recomputes its sample's gate from the
//      partial sums (two tiny fcs), then z * gate + residual, relu.
//
// C interface (loaded with ctypes): eg_se_stage_fp32(...) and
// eg_se_stage_bf16(...) return the cudaError_t code of their launches (0:
// launched); eg_se_active_clusters(n, smem) the number of clusters of the
// bf16 kernel the card holds at once. The wrapper picks the bf16 layout
// (fused_se_stage.cluster_layout: R rows per CTA, n CTAs, smem bytes);
// eg_se_stage_bf16 only checks that the kernel takes it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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


// The SE gate of one sample, run by 256 threads (8 warps) with `sync()`
// between its steps: threads tid < 128 hand in channel tid's sum of z over
// the sample's pixels; pool = T(sum / HW), hid = T(relu(pool @ f1w + f1b)),
// gate = sigmoid(hid @ f2w + f2b) into `gate`.
template <typename T, typename Sync>
__device__ __forceinline__ void se_gate(float sum, int HW,
                                        const T* __restrict__ f1w,
                                        const float* __restrict__ f1b,
                                        const T* __restrict__ f2w,
                                        const float* __restrict__ f2b,
                                        int hidden, float* pool, float* hid,
                                        float* gate, Sync sync) {
  const int tid = threadIdx.x;
  if (tid < kC) pool[tid] = round_to<T>(sum / (float)HW);
  sync();
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
  sync();
  if (tid < kC) {
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < hidden; ++j)
      s = fmaf(hid[j], to_float(f2w[(size_t)j * kC + tid]), s);
    gate[tid] = 1.f / (1.f + expf(-(s + f2b[tid])));
  }
  sync();
}

// fp32: one block per (pixel tile, sample): the sample's SE gate from the
// conv2 kernel's partial sums, then out = relu(z * gate + res) over the tile.
__global__ void __launch_bounds__(kThreads)
se_gate_kernel(const float* __restrict__ z, const float* __restrict__ res,
               const float* __restrict__ partial, int HW,
               const float* __restrict__ f1w, const float* __restrict__ f1b,
               const float* __restrict__ f2w, const float* __restrict__ f2b,
               int hidden, float* __restrict__ out) {
  __shared__ float pool[kC];
  __shared__ float hid[kMaxHidden];
  __shared__ __align__(16) float gate[kC];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = gridDim.x;
  float sum = 0.f;
  if (tid < kC)
    for (int t = 0; t < n_tiles; ++t)
      sum += partial[((size_t)b * n_tiles + t) * kC + tid];
  se_gate<float>(sum, HW, f1w, f1b, f2w, f2b, hidden, pool, hid, gate,
                 [] { __syncthreads(); });

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

// ---------------------------------------------------------------------------
// bf16: the whole stage in one launch, one cluster per sample
// ---------------------------------------------------------------------------

constexpr bool kMulticast = true;      // weight tiles multicast to the cluster
constexpr int kConsumerWarps = 8;      // two warpgroups of wgmma
constexpr int kConsumers = kConsumerWarps * 32;
// + a producer warpgroup: one warp issues the TMA loads, three copy the
// halo rows from the neighbouring CTAs
constexpr int kStageThreads = kConsumers + 128;
constexpr int kHaloThreads = 96;
constexpr int kStages = 4;             // weight ring slots
constexpr int kWTile = kC * 64 * 2;    // 128 out x 64 in channels, bf16
constexpr int kSlices = 8;             // a tile's TMA boxes of 16 rows
constexpr int kSliceRows = kC / kSlices;
constexpr int kKTiles = 18;            // 9 taps x 2 halves of 64 channels
constexpr int kPixelBytes = kC * 2;
constexpr int kMaxCluster = 8;
// shared memory besides the ring, the two activation tiles and the SE fc
// weights: alignment slack, the pool's per-warp and per-CTA sums, pool,
// hidden, gate, the block's affines s1, t1, s2, t2, the ring's and the two
// halo mbarriers
constexpr int kBaseSmem = 1024 + kConsumerWarps * kC * 4 + 3 * kC * 4 +
                          kMaxHidden * 4 + 4 * kC * 4 + 2 * kStages * 8 + 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same offset in CTA `cta` of the cluster
// (it orders no memory: the slot's reader, wgmma, has finished)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint4 ld_remote_v4(uint32_t addr, uint32_t cta) {
  uint4 v;
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %4, %5;\n"
      "ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [ra];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(addr), "r"(cta)
      : "memory");
  return v;
}

__device__ __forceinline__ float ld_remote_f32(uint32_t addr, uint32_t cta) {
  float v;
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [ra];\n"
      "}\n"
      : "=f"(v)
      : "r"(addr), "r"(cta)
      : "memory");
  return v;
}

// TMA: a box of the weight tensor map into this CTA's shared memory, or
// into the same offset of every CTA in `mask`, completing on the barrier at
// the same offset in each
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma descriptor of a K-major tile of 8-row groups 1024 bytes apart, each
// row 128 bytes under the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, fp32) = (scale_d ? d : 0) + a (64 x 16, bf16, registers) *
// b (16 x 128, bf16, shared memory by descriptor)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// the taps in the order a conv runs them: the centre row (taps 3, 4, 5)
// first, which reads no halo row, so the halo rows can arrive behind it
__device__ __forceinline__ int tap_at(int i) {
  return i < 3 ? i + 3 : (i < 6 ? i - 3 : i);
}

// one step of a transposing butterfly over the 8 lanes that share lane & 3:
// the lane whose bit `kHalf` is set keeps columns [kHalf, 2 kHalf) of cs,
// the other [0, kHalf), each adding its partner's; the kept ones move to
// cs[0, kHalf)
template <int kHalf>
__device__ __forceinline__ void fold_columns(float (&cs)[32], int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float give = upper ? cs[k] : cs[k + kHalf];
    const float keep = upper ? cs[k + kHalf] : cs[k];
    cs[k] = keep + __shfl_xor_sync(0xffffffffu, give, kHalf);
  }
}

// byte offset of channel chunk `cg` (8 channels) of tile pixel p: the
// chunks of a pixel are XOR-swizzled by p's low 3 bits, so eight
// consecutive pixels' chunk cg fall in eight different bank groups
__device__ __forceinline__ uint32_t tile_off(int p, int cg) {
  return (uint32_t)p * kPixelBytes + (uint32_t)((cg ^ (p & 7)) << 4);
}

// The halo rows of a tile (bytes at `tile`, generic pointer `tile_gen`)
// from the neighbouring CTAs' edge rows over DSMEM: halo thread h of
// kHaloThreads takes 16-byte chunks in turn, 4 loads in flight. The first
// and last CTA keep their zero rows.
__device__ __forceinline__ void copy_halo(uint32_t tile, uint8_t* tile_gen,
                                          int h, int R, int P, uint32_t rank,
                                          uint32_t n) {
  const int nq = P * 16;  // chunks per halo row
  for (int q0 = h; q0 < 2 * nq; q0 += 4 * kHaloThreads) {
    uint4 v[4];
    int dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * kHaloThreads;
      const int below = q >= nq, qq = q - below * nq;
      const int src = (int)rank + (below ? 1 : -1);
      const int tc = qq >> 4, cg = qq & 15;
      dst[u] = -1;
      if (q < 2 * nq && src >= 0 && src < (int)n) {
        dst[u] = tile_off((below ? R + 1 : 0) * P + tc, cg);
        v[u] = ld_remote_v4(tile + tile_off((below ? 1 : R) * P + tc, cg),
                            src);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dst[u] >= 0) *reinterpret_cast<uint4*>(tile_gen + dst[u]) = v[u];
  }
}

// One cluster of n CTAs per sample (blockIdx.y); CTA `rank` owns image rows
// rank * R ... rank * R + R - 1 (rows >= H are zero). Warps 0-7 are the
// wgmma consumers, warp 8 the TMA producer, warps 9-11 the halo copies. The
// weights `wmap` are a tensor map over (NB * 2 * 9 * 128 rows of output
// channels, 128 input channels): row ((blk * 2 + conv) * 9 + tap) * 128 + co
// holds w[tap][:, co].
__global__ void __launch_bounds__(kStageThreads, 1)
se_stage_cluster_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ out,
                        const float* __restrict__ s1,
                        const float* __restrict__ t1,
                        const float* __restrict__ s2,
                        const float* __restrict__ t2,
                        const __nv_bfloat16* __restrict__ f1w,
                        const float* __restrict__ f1b,
                        const __nv_bfloat16* __restrict__ f2w,
                        const float* __restrict__ f2b, int H, int W, int R,
                        int NB, int hidden) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-B
  uint8_t* const gen = smem_raw + (ring - raw);
  const int P = W + 2;                           // tile pitch in pixels
  const int tile_bytes = (R + 2) * P * kPixelBytes;
  const uint32_t xt = ring + kStages * kWTile;   // block input / output
  const uint32_t yt = xt + tile_bytes;           // bn1's output
  uint8_t* const xg = gen + kStages * kWTile;
  uint8_t* const yg = xg + tile_bytes;
  float* const red = reinterpret_cast<float*>(yg + tile_bytes);
  float* const partial = red + kConsumerWarps * kC;
  float* const pool = partial + kC;
  float* const hid = pool + kC;
  float* const gate = hid + kMaxHidden;
  float* const aff = gate + kC;                  // s1, t1, s2, t2
  // the block's SE fc weights f1w (128 x hidden), f2w (hidden x 128)
  __nv_bfloat16* const fcw = reinterpret_cast<__nv_bfloat16*>(aff + 4 * kC);
  const uint32_t full = smem_u32(fcw + 2 * kC * hidden);  // mbarriers
  const uint32_t empty = full + kStages * 8;     // kStages mbarriers
  const uint32_t x_halo = empty + kStages * 8;   // the x tile's halo is in
  const uint32_t y_halo = x_halo + 8;            // the y tile's halo is in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank(), n = cluster_size();
  const bool multicast = kMulticast && n > 1;
  const int b = blockIdx.y;
  const int r0 = (int)rank * R;
  const size_t sample = (size_t)b * H * W * kC;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      // every consumer warp of every CTA that reads the slot releases it
      mbar_init(empty + 8 * s, kConsumerWarps * (multicast ? n : 1));
    }
    mbar_init(x_halo, kHaloThreads);
    mbar_init(y_halo, kHaloThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the input rows r0 - 1 ... r0 + R with their halo (zero outside the
  // image) into the x tile; the y tile zeroed (its halo columns stay zero)
  // (8 loads in flight per thread)
  const int chunks = (R + 2) * P * 16;
  for (int q0 = tid; q0 < chunks; q0 += 8 * kStageThreads) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * kStageThreads;
      const int p = q >> 4, cg = q & 15;
      const int gh = r0 - 1 + p / P, gw = p % P - 1;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (q < chunks && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v[u] = *reinterpret_cast<const uint4*>(
            x + sample + ((size_t)gh * W + gw) * kC + cg * 8);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * kStageThreads;
      if (q < chunks) {
        *reinterpret_cast<uint4*>(xg + tile_off(q >> 4, q & 15)) = v[u];
        *reinterpret_cast<uint4*>(yg + q * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cluster_sync();  // barriers initialised and tiles loaded in every CTA

  // the producer warpgroup (warps 8-11): all four warps give up registers
  // at one setmaxnreg, as PTX requires of a warpgroup, inside a branch the
  // consumers never reach: placed before the branches, on a path the
  // consumers rejoin, it slowed the bf16 stage by ~4% (chip_smoke.py phase
  // 2c, 7.30 against 7.03 ms on an H100 SXM)
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp > kConsumerWarps) {
      // ---- halo warps: each tile's halo rows from the neighbours' edge rows,
      // once the cluster barrier after their writes has passed; the consumers
      // meanwhile run the centre-row taps, which read no halo row ----
      const int h = tid - kConsumers - 32;
      for (int blk = 0; blk < NB; ++blk) {
        if (blk > 0) {  // the last block's output, the x tile's halo
          cluster_wait();
          copy_halo(xt, xg, h, R, P, rank, n);
          mbar_arrive(x_halo);
        }
        cluster_arrive();
        cluster_wait();
        copy_halo(yt, yg, h, R, P, rank, n);
        mbar_arrive(y_halo);
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
      }
      cluster_wait();
      return;
    }
    // ---- producer: 18 weight tiles per conv, in the consumers' order ----
    int stage = 0;
    uint32_t phase = 0;
    auto issue = [&](int blk, int conv) {
      for (int kt = 0; kt < kKTiles; ++kt) {
        if (lane == 0) {
          const uint32_t f = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(f, kWTile);
          const int row = ((blk * 2 + conv) * 9 + tap_at(kt / 2)) * kC;
          const int col = (kt & 1) * 64;
          const uint32_t dst = ring + stage * kWTile;
          if (multicast) {
            // this CTA's share of the tile, to every CTA of the cluster
            for (int j = rank; j < kSlices; j += n)
              tma_load_multicast(dst + j * (kWTile / kSlices), &wmap, col,
                                 row + j * kSliceRows, f,
                                 (uint16_t)((1u << n) - 1));
          } else {
            for (int j = 0; j < kSlices; ++j)
              tma_load(dst + j * (kWTile / kSlices), &wmap, col,
                       row + j * kSliceRows, f);
          }
        }
        __syncwarp();
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    };
    // the consumers pass three cluster barriers per block (after conv1,
    // after the pool's partial sums, after the block's output); this warp
    // arrives at each once it has issued every tile due before it, and
    // waits for each before it arrives at the next, so it runs ahead
    // into the next conv's tiles while the consumers are at a barrier
    for (int blk = 0; blk < NB; ++blk) {
      issue(blk, 0);
      if (blk > 0) cluster_wait();
      cluster_arrive();
      issue(blk, 1);
      cluster_wait();
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg takes GEMM rows wg * 64 ... + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int RW = R * W;
  // the row this lane addresses for ldmatrix, as the tile pixel of tap
  // (0, 0); rows past R * W read pixel 0 and are dropped
  int mld = wg * 64 + wq * 16 + (lane & 15);
  if (mld >= RW) mld = 0;
  const int pb = (mld / W) * P + mld % W;
  const int hi = lane >> 4;
  // the two accumulator rows of this thread: tile pixel, and whether the
  // row is a pixel of the CTA (in_m) inside the image (in_img)
  int pe[2];
  bool in_m[2], in_img[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wg * 64 + wq * 16 + g + 8 * i;
    in_m[i] = m < RW;
    const int r = in_m[i] ? m / W : 0, c = in_m[i] ? m % W : 0;
    pe[i] = (r + 1) * P + c + 1;
    in_img[i] = in_m[i] && r0 + r < H;
  }

  float acc[64];
  int stage = 0;
  uint32_t phase = 0;
  // a warp frees a slot in every CTA whose producer writes it: lane r
  // arrives at CTA r's empty barrier
  auto release = [&](int s) {
    __syncwarp();
    if (multicast) {
      if (lane < (int)n) mbar_arrive_remote(empty + 8 * s, lane);
    } else if (lane == 0) {
      mbar_arrive(empty + 8 * s);
    }
  };
  // one 3x3 conv over `tile` into acc: 9 taps of 2 k-tiles of 64 input
  // channels, each 4 wgmma k16 steps; one k-tile's wgmma stay in flight
  // while the next one's A fragments load. The centre-row taps read no
  // halo row; halo_in() waits for the halo rows before the other taps.
  auto conv = [&](uint32_t tile, auto halo_in) {
    uint32_t a[2][4][4];
    int prev = 0;
#pragma unroll 1
    for (int i = 0; i < 9; ++i) {
      if (i == 3) halo_in();
      const int tap = tap_at(i);
      const int pt = pb + (tap / 3) * P + tap % 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(a[h][kk], tile + tile_off(pt, h * 8 + kk * 2 + hi));
        mbar_wait(full + 8 * stage, phase);
        wgmma_fence();
        const uint64_t desc = wgmma_desc(ring + stage * kWTile);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16(acc, a[h][kk], desc + 2 * kk, i + h + kk);
        wgmma_commit();
        if (i + h > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    release(prev);
  };
  uint32_t x_phase = 0, y_phase = 0;

  for (int blk = 0; blk < NB; ++blk) {
    // the block's affines and SE fc weights into shared memory while
    // conv1 runs
    if (tid < kC) {
      const int which = tid >> 5;
      const float* src = which == 0   ? s1
                         : which == 1 ? t1
                         : which == 2 ? s2
                                      : t2;
      cp_async16(aff + tid * 4, src + blk * kC + (tid & 31) * 4);
    }
    for (int q = tid; q < 4 * kC * hidden / 16; q += kConsumers) {
      const int half = kC * hidden / 8;  // 16-byte chunks per matrix
      const size_t at = (size_t)blk * half + (q < half ? q : q - half);
      cp_async16(fcw + q * 8, (q < half ? f1w : f2w) + at * 8);
    }
    cp_async_commit();
    // the x tile's halo: loaded with it for the first block, else the
    // neighbours' last output rows, copied by the halo warps
    conv(xt, [&] {
      if (blk > 0) {
        mbar_wait(x_halo, x_phase);
        x_phase ^= 1;
      }
    });
    cp_async_wait();
    consumer_sync();
    // y = bf16(relu(conv) * s1 + t1) into the y tile (0 past the image)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(aff + c);
      const float2 sh = *reinterpret_cast<const float2*>(aff + kC + c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!in_m[i]) continue;
        const float v0 =
            in_img[i] ? fmaxf(acc[4 * j + 2 * i], 0.f) * sc.x + sh.x : 0.f;
        const float v1 =
            in_img[i] ? fmaxf(acc[4 * j + 2 * i + 1], 0.f) * sc.y + sh.y : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(yg + tile_off(pe[i], j) + 4 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    // y is written: the cluster barrier the halo warps wait for
    if (blk > 0) cluster_wait();  // (the previous block's last barrier)
    cluster_arrive();
    consumer_sync();
    conv(yt, [&] {
      mbar_wait(y_halo, y_phase);
      y_phase ^= 1;
    });
    // z = conv * s2 + t2, kept in acc; the CTA's column sums of z over its
    // image pixels in a fixed order: the thread's two rows, then the 8
    // lanes that share t by a transposing butterfly (each step hands half
    // of the columns to the partner lane, 16 + 8 + 4 shuffles), then the
    // warps
    float cs[32];  // column k = 2j + e: channel 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 sc2 = *reinterpret_cast<const float2*>(aff + 2 * kC + c);
      const float2 sh2 = *reinterpret_cast<const float2*>(aff + 3 * kC + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = e ? sc2.y : sc2.x, sh = e ? sh2.y : sh2.x;
        acc[4 * j + e] = acc[4 * j + e] * sc + sh;
        acc[4 * j + 2 + e] = acc[4 * j + 2 + e] * sc + sh;
        cs[2 * j + e] = (in_img[0] ? acc[4 * j + e] : 0.f) +
                        (in_img[1] ? acc[4 * j + 2 + e] : 0.f);
      }
    }
    fold_columns<16>(cs, lane);
    fold_columns<8>(cs, lane);
    fold_columns<4>(cs, lane);
    // lane keeps columns k = 4g + i: channel 16g + 8(i / 2) + 2t + i % 2
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[warp * kC + 16 * g + 8 * (i >> 1) + 2 * t + (i & 1)] = cs[i];
    consumer_sync();
    if (tid < kC) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) s += red[w * kC + tid];
      partial[tid] = s;
    }
    cluster_wait();  // (the barrier after y)
    cluster_sync();
    // the sample's sum: the cluster's partials in rank order, over DSMEM
    float sum = 0.f;
    if (tid < kC) {
      float part[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        part[r] = r < (int)n ? ld_remote_f32(smem_u32(partial + tid), r) : 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) sum += part[r];
    }
    se_gate<__nv_bfloat16>(sum, H * W, fcw, f1b + blk * hidden,
                           fcw + kC * hidden, f2b + blk * kC, hidden, pool,
                           hid, gate, [] { consumer_sync(); });
    // x = bf16(relu(z * gate + x)), over the input tile
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gt = *reinterpret_cast<const float2*>(gate + c);
      const float ga = gt.x, gb = gt.y;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!in_m[i]) continue;
        __nv_bfloat162* px =
            reinterpret_cast<__nv_bfloat162*>(xg + tile_off(pe[i], j) + 4 * t);
        const float2 xv = __bfloat1622float2(*px);
        const float v0 =
            in_img[i] ? fmaxf(acc[4 * j + 2 * i] * ga + xv.x, 0.f) : 0.f;
        const float v1 =
            in_img[i] ? fmaxf(acc[4 * j + 2 * i + 1] * gb + xv.y, 0.f) : 0.f;
        *px = __floats2bfloat162_rn(v0, v1);
      }
    }
    cluster_arrive();
    consumer_sync();
  }
  // the last block's output rows, from the x tile to device memory
  for (int q = tid; q < RW * 16; q += kConsumers) {
    const int m = q >> 4, cg = q & 15;
    const int r = m / W, c = m % W;
    if (r0 + r >= H) break;
    const uint4 v = *reinterpret_cast<const uint4*>(
        xg + tile_off((r + 1) * P + c + 1, cg));
    *reinterpret_cast<uint4*>(out + sample + ((size_t)(r0 + r) * W + c) * kC +
                              cg * 8) = v;
  }
  cluster_wait();  // no CTA exits while another may still read its tiles
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int run_stage_fp32(const float* x, float* out, float* tmp, float* y1,
                   float* z, float* partial, const float* w1,
                   const float* s1, const float* t1, const float* w2,
                   const float* s2, const float* t2, const float* f1w,
                   const float* f1b, const float* f2w, const float* f2b,
                   int B, int H, int W, int NB, int hidden,
                   cudaStream_t stream) {
  const int HW = H * W;
  const dim3 grid((HW + kBM - 1) / kBM, B);
  const size_t wsize = (size_t)9 * kC * kC;
  const float* cur = x;
  for (int i = 0; i < NB; ++i) {
    // the last block writes `out`; blocks alternate between out and tmp,
    // so no block reads what it writes
    float* dst = ((NB - 1 - i) % 2 == 0) ? out : tmp;
    conv3x3_kernel<0><<<grid, kThreads, 0, stream>>>(
        cur, w1 + i * wsize, s1 + i * kC, t1 + i * kC, y1, nullptr, nullptr,
        H, W);
    conv3x3_kernel<1><<<grid, kThreads, 0, stream>>>(
        y1, w2 + i * wsize, s2 + i * kC, t2 + i * kC, nullptr, z, partial,
        H, W);
    se_gate_kernel<<<grid, kThreads, 0, stream>>>(
        z, cur, partial, HW, f1w + (size_t)i * kC * hidden, f1b + i * hidden,
        f2w + (size_t)i * hidden * kC, f2b + i * kC, hidden, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = dst;
  }
  return 0;
}

// the dynamic shared memory se_stage_cluster_kernel carves at R rows of W
// pixels per CTA: kBaseSmem, the weight ring, the two activation tiles and
// the block's SE fc weights
int cluster_smem(int R, int W, int hidden) {
  return kBaseSmem + kStages * kWTile + 2 * (R + 2) * (W + 2) * kPixelBytes +
         4 * kC * hidden;
}

// whether the bf16 kernel takes the layout the wrapper chose: n CTAs of R
// whole rows cover the H rows with none left empty, a CTA's R * W pixels
// fit its 128 GEMM rows, and smem holds the kernel's carve-up (the card
// itself refuses more shared memory than a CTA may have)
bool layout_ok(int H, int W, int R, int n, int hidden, int smem) {
  return H >= 1 && W >= 1 && R >= 1 && R * W <= kC && n >= 1 &&
         n <= kMaxCluster && (n - 1) * R < H && H <= n * R && hidden >= 1 &&
         hidden <= kMaxHidden && smem >= cluster_smem(R, W, hidden);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

cudaLaunchConfig_t cluster_config(int B, int n, int smem,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, B);
  cfg.blockDim = dim3(kStageThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// x, out, tmp, y1, z: (B, H, W, 128) fp32; partial: (B, ceil(H*W / 128),
// 128) fp32; w1, w2: (NB, 3, 3, 128, 128) HWIO, f1w (NB, 128, hidden), f2w
// (NB, hidden, 128), s1, t1, s2, t2, f2b (NB, 128) and f1b (NB, hidden), all
// fp32. tmp is unused when NB == 1. All contiguous.
extern "C" int eg_se_stage_fp32(const void* x, void* out, void* tmp, void* y1,
                                void* z, void* partial, const void* w1,
                                const void* s1, const void* t1,
                                const void* w2, const void* s2,
                                const void* t2, const void* f1w,
                                const void* f1b, const void* f2w,
                                const void* f2b, int B, int H, int W, int NB,
                                int hidden, void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || B < 1 || B > 65535 || H < 1 ||
      W < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return run_stage_fp32(f(x), static_cast<float*>(out),
                        static_cast<float*>(tmp), static_cast<float*>(y1),
                        static_cast<float*>(z), static_cast<float*>(partial),
                        f(w1), f(s1), f(t1), f(w2), f(s2), f(t2), f(f1w),
                        f(f1b), f(f2w), f(f2b), B, H, W, NB, hidden,
                        static_cast<cudaStream_t>(stream));
}

// x, out: (B, H, W, 128) bf16; wk: (NB, 2, 9, 128, 128) bf16, conv c's tap
// k as (output, input channel), K-major (the wrapper's pack_weights); f1w
// (NB, 128, hidden), f2w (NB, hidden, 128) bf16; s1, t1, s2, t2, f2b
// (NB, 128) and f1b (NB, hidden) fp32. All contiguous. A cluster of n CTAs
// of R rows per sample, with smem bytes of dynamic shared memory each.
extern "C" int eg_se_stage_bf16(const void* x, void* out, const void* wk,
                                const void* s1, const void* t1,
                                const void* s2, const void* t2,
                                const void* f1w, const void* f1b,
                                const void* f2w, const void* f2b, int B,
                                int H, int W, int R, int n, int NB,
                                int hidden, int smem, void* stream) {
  if (B < 1 || B > 65535 || NB < 1 || !layout_ok(H, W, R, n, hidden, smem))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)kC, (cuuint64_t)NB * 2 * 9 * kC};
  const cuuint64_t strides[1] = {(cuuint64_t)kC * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)kSliceRows};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(wk), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se_stage_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      B, n, smem, attr, static_cast<cudaStream_t>(stream));
  typedef const __nv_bfloat16* CB;
  typedef const float* CF;
  err = cudaLaunchKernelEx(
      &cfg, se_stage_cluster_kernel, wmap, static_cast<CB>(x),
      static_cast<__nv_bfloat16*>(out), static_cast<CF>(s1),
      static_cast<CF>(t1), static_cast<CF>(s2), static_cast<CF>(t2),
      static_cast<CB>(f1w), static_cast<CF>(f1b), static_cast<CB>(f2w),
      static_cast<CF>(f2b), H, W, R, NB, hidden);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n CTAs of the bf16 kernel, with smem bytes of
// dynamic shared memory each, the card runs at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
extern "C" int eg_se_active_clusters(int n, int smem) {
  if (n < 1 || n > kMaxCluster || smem < 1)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se_stage_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, n, smem, attr, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, se_stage_cluster_kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}
