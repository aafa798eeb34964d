// Fused eval-mode post-LN multi-head attention sublayer for Hopper (sm_90a).
//
// Replaces the TPU kernel emotiongestures_tpu/ops/pallas_attention.py
// (_mha_kernel, driven by fused_attention / fused_self_attention). Per batch
// element it computes
//
//     q = q_in Wq^T, k = kv_in Wk^T, v = kv_in Wv^T        (bias-free)
//     ctx_h = softmax(q_h k_h^T / sqrt(d_k)) v_h           (keys >= Lk masked)
//     out = LayerNorm(ctx Wo^T + q_in), eps 1e-6, scale and bias
//
// with fp32 sums and exact products whatever the input types: the query
// (fp32 or bf16), the keys/values (fp32) and the weights (fp32 or bf16).
// Output is fp32. These are the types the serving path gives it: fp32
// throughout, or under bf16 serving fp32 activations (a bf16 query in the
// first decoder layer) with bf16 weights.
//
// Bounds on an H100 SXM (data-sheet peaks, 700 W), at B=1024, L=60,
// d_model=512: the sublayer is 136.4 GFLOP (128.8 of projections, 7.5 of the
// attention core) and moves 0.25 GB (self-attention) to 0.38 GB (cross,
// fp32), 0.08-0.11 ms at 3.35 TB/s. The same work in plain fp32 FMA takes
// 2.04 ms at 67 TFLOP/s. On the tensor cores a fp32 operand takes three
// bf16 terms or two TF32 terms to keep its accuracy; the least time of the
// products so, each at the cheaper recipe, is 0.44 ms with fp32 activations
// and bf16 weights (three bf16 passes at 989 TFLOP/s) and 0.83 ms in fp32
// throughout (3xTF32 at 495). This design runs 2 or 3 TF32 passes: 280.3
// GFLOP (0.57 ms at 495 TFLOP/s) with bf16 weights, 409.2 (0.83 ms) in fp32.
//
// Precision recipe (mma.sync m16n8k8 TF32, fp32 sums). hi = rna_tf32(x),
// lo = rna_tf32(x - hi), rounded to nearest with ties away from zero as
// cvt.rna.tf32.f32 does; a bf16 value is exact in TF32 and is not split:
//
//     A operand            weights   products
//     fp32 (act. or ctx)   fp32      A_lo W_hi + A_hi W_lo + A_hi W_hi (3xTF32)
//     fp32 (act. or ctx)   bf16      A_lo W + A_hi W
//     bf16 query           bf16      A W (exact products, the TPU's math)
//     bf16 query           fp32      A W_lo + A W_hi
//
// and 3xTF32 for the core's Q K^T and P V (all fp32). A single TF32 pass
// (errors ~5e-4) or a single bf16 pass over fp32 activations (~3e-3) would
// miss the tolerance of the TPU kernel's tests (rtol 2e-4, atol 2e-5). The
// split's products are exact. Each 8-deep k-step's products are summed by
// the mma into a fresh accumulator and added to the running sum by fp32
// adds (add4): at the serving shapes that reads 2.0-2.4e-6 against the plain
// fp32 version, where the tensor cores' own running sum read 1.3-2.3e-5.
//
// Design (simple first version, three launches per sublayer, mma.sync and
// cp.async; no wgmma or TMA yet):
//   1. mha_qkv_kernel: the Q, K and V projections as tiled GEMMs over the
//      flattened B*L rows, one block per 128 rows x 128 output columns of
//      one of the three weights (the Q tiles over q_in, the K and V tiles
//      over kv_in, all in one grid), two blocks per SM, k-steps of 32
//      staged by cp.async in a ring of padded stages (three with bf16
//      weights, two with fp32). Q (scaled by 1/sqrt(d_k)), K and V go to an
//      fp32 head-major scratch (B, H, L, d_k) each.
//   2. mha_core_kernel, one block of four warps per (batch element, head):
//      the head's Q, K, V from the scratch into shared memory, each warp's
//      16 rows of scores, key mask, softmax and ctx_h = P V in registers,
//      ctx written to an fp32 scratch (B, Lq, H*d_k).
//   3. mha_out_ln_kernel, one block per 64 rows x all d_model columns: the
//      output projection with the same split mma, the residual, and
//      LayerNorm from per-warp row partials in shared memory.
// Rows past B*L and weight rows past H*d_k load as zeros (cp.async
// zero-fill); key columns >= Lk are masked by index.
//
// C interface (loaded with ctypes): eg_attention(...) returns the
// cudaGetLastError() code after its launches; 0 means all three launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // k-depth of a staged GEMM tile

// Shared-memory row stride, in elements, of a staged [rows][kBK] tile: 40
// floats (fragment pairs as 64-bit loads) or 40 bf16 (pairs as 32-bit
// loads) put the lanes of a fragment load on distinct banks and keep each
// row 16-byte aligned for cp.async.
constexpr int kLd = kBK + 8;

// two consecutive elements as floats; p must be 4- (bf16) or 8-byte aligned
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes from device to shared memory; zeros where !ok (src-size 0, the
// source is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to the nearest TF32 value, ties away from zero: the rounding of
// cvt.rna.tf32.f32, in two integer ops (add half an ulp of TF32 to the
// magnitude bits, clear the 13 low bits). Finite inputs only.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32. A value that is exact in TF32 (a widened bf16) is
// passed through as hi, and lo is not used.
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (kSplit) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a (16 x 8, row) * b (8 x 8, col): TF32 products, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += c by fp32 adds (round to nearest). Each 8-deep k-step's products
// are summed by the mma into a fresh c and added to the running sum here:
// the tensor cores' own fp32 sum truncates at the exponent of what it adds
// to, which along a 512-deep chain reads ~10x the error of fp32.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

template <typename TA, typename TW, int BM, int BN>
__host__ __device__ constexpr size_t gemm_stage_bytes() {
  return kLd * (BM * sizeof(TA) + BN * sizeof(TW));
}

// stages of the cp.async ring: three where kBlocks blocks of them fit on
// an SM, else two
template <typename TA, typename TW, int BM, int BN, int kBlocks>
__host__ __device__ constexpr int gemm_stages() {
  return kBlocks * 3 * gemm_stage_bytes<TA, TW, BM, BN>() <= 220 * 1024 ? 3
                                                                        : 2;
}

template <typename TA, typename TW, int BM, int BN, int kBlocks>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return gemm_stages<TA, TW, BM, BN, kBlocks>() *
         gemm_stage_bytes<TA, TW, BM, BN>();
}

// acc = A[0:BM, 0:K] W[0:BN, 0:K]^T for one block, on the tensor cores with
// the split recipe of the header. A (row stride lda) and W (torch's (out,
// in) layout, row stride ldw) point at the block's first row; rows of A at
// or past rows_ok and rows of W at or past cols_ok load as zeros. The eight
// warps form an (8 / WN) x WN grid, each owning (MT*16) x (NT*8) outputs;
// acc[i][j] is mma tile (i, j) of the warp in the m16n8 accumulator layout.
// K is a multiple of kBK; smem holds gemm_smem_bytes<TA, TW, BM, BN,
// kBlocks>(), a ring of gemm_stages() k-steps filled by cp.async, where
// kBlocks blocks are to share an SM.
//
// Within each 8-deep step the mma's k index is permuted (its k = t and
// t + 4 read columns 2t and 2t + 1, the same in A and W), so a lane's two
// values of a fragment row are neighbours and load together.
template <typename TA, typename TW, int BM, int BN, int WN, int MT, int NT,
          int kBlocks>
__device__ __forceinline__ void gemm_tile(const TA* __restrict__ A, int lda,
                                          int rows_ok,
                                          const TW* __restrict__ W, int ldw,
                                          int cols_ok, int K,
                                          unsigned char* smem,
                                          float (&acc)[MT][NT][4]) {
  static_assert((kThreads / 32 / WN) * MT * 16 == BM, "rows of the warps");
  static_assert(WN * NT * 8 == BN, "columns of the warps");
  constexpr int kStages = gemm_stages<TA, TW, BM, BN, kBlocks>();
  constexpr int kStageA = BM * kLd, kStageW = BN * kLd;  // elements
  constexpr bool kSplitA = std::is_same<TA, float>::value;
  constexpr bool kSplitW = std::is_same<TW, float>::value;
  constexpr int kChA = 16 / sizeof(TA), kChW = 16 / sizeof(TW);
  constexpr int kRowChA = kBK / kChA, kRowChW = kBK / kChW;
  TA* sA = reinterpret_cast<TA*>(smem);
  TW* sW = reinterpret_cast<TW*>(smem + kStages * kStageA * sizeof(TA));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * MT * 16, wc = (warp % WN) * NT * 8;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = K / kBK;
  // k-step kt into ring slot kt % kStages; one commit group per k-step,
  // empty past the last, so that waiting for all but kStages - 2 groups
  // always means k-step kt has landed
  auto load = [&](int kt) {
    if (kt < nk) {
      const int stage = kt % kStages, k0 = kt * kBK;
      TA* a = sA + stage * kStageA;
      for (int c = tid; c < BM * kRowChA; c += kThreads) {
        const int r = c / kRowChA, kc = (c % kRowChA) * kChA;
        const bool ok = r < rows_ok;
        cp_async16(a + r * kLd + kc,
                   A + (size_t)(ok ? r : 0) * lda + k0 + kc, ok);
      }
      TW* w = sW + stage * kStageW;
      for (int c = tid; c < BN * kRowChW; c += kThreads) {
        const int r = c / kRowChW, kc = (c % kRowChW) * kChW;
        const bool ok = r < cols_ok;
        cp_async16(w + r * kLd + kc,
                   W + (size_t)(ok ? r : 0) * ldw + k0 + kc, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) load(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // k-step kt is visible to all, and every warp is done with the slot
    // that the next load refills (k-step kt - 1's)
    __syncthreads();
    load(kt + kStages - 1);
    const TA* a = sA + (kt % kStages) * kStageA;
    const TW* w = sW + (kt % kStages) * kStageW;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // a[i]: rows g and g + 8 of m tile i, columns 2t and 2t + 1
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const TA* p = a + (wr + i * 16 + g) * kLd + kk + 2 * t;
        const float2 x0 = load2(p), x1 = load2(p + 8 * kLd);
        split_tf32<kSplitA>(x0.x, ah[i][0], al[i][0]);
        split_tf32<kSplitA>(x1.x, ah[i][1], al[i][1]);
        split_tf32<kSplitA>(x0.y, ah[i][2], al[i][2]);
        split_tf32<kSplitA>(x1.y, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = load2(w + (wc + j * 8 + g) * kLd + kk + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32<kSplitW>(y.x, bh[0], bl[0]);
        split_tf32<kSplitW>(y.y, bh[1], bl[1]);
        // the small terms first, then the large one
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          if (kSplitA) mma_tf32(c, al[i], bh[0], bh[1]);
          if (kSplitW) mma_tf32(c, ah[i], bl[0], bl[1]);
          mma_tf32(c, ah[i], bh[0], bh[1]);
          add4(acc[i][j], c);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller's epilogue
}

// ---------------------------------------------------------------------------
// Launch 1: Q, K, V projections into the head-major scratch.
// ---------------------------------------------------------------------------
constexpr int kPBM = 128, kPBN = 128;  // block tile: rows x output columns
constexpr int kPBlocks = 2;            // blocks per SM

template <typename TA, typename TW>
__device__ __forceinline__ void project_tile(const TA* __restrict__ x,
                                             const TW* __restrict__ w,
                                             float* __restrict__ dst, int L,
                                             int R, int row0, int n0, int D,
                                             int H, int dk, float scale,
                                             unsigned char* smem) {
  const int HD = H * dk;
  // warps as 4 (rows) x 2 (columns), each 32 x 64
  float acc[2][8][4];
  gemm_tile<TA, TW, kPBM, kPBN, 2, 2, 8, kPBlocks>(
      x + (size_t)row0 * D, D, R - row0, w + (size_t)n0 * D, D, HD - n0, D,
      smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wr + i * 16 + g + 8 * half;
      if (r >= R) continue;
      const int b = r / L, l = r - b * L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + wc + j * 8 + 2 * t;  // c, c + 1: one head
        if (c >= HD) continue;
        const int h = c / dk, d = c - h * dk;
        *reinterpret_cast<float2*>(
            dst + (((size_t)b * H + h) * L + l) * dk + d) =
            make_float2(acc[i][j][2 * half] * scale,
                        acc[i][j][2 * half + 1] * scale);
      }
    }
}

// Block -> (row tile, column tile); column tiles 0..nct-1 are Wq's over
// q_in, then Wk's and Wv's over kv_in. qkv holds Q (B, H, Lq, dk), then K
// and V (B, H, Lk, dk).
template <typename TQ, typename TW>
__global__ void __launch_bounds__(kThreads, kPBlocks)
mha_qkv_kernel(const TQ* __restrict__ q_in, const float* __restrict__ kv_in,
               const TW* __restrict__ wq, const TW* __restrict__ wk,
               const TW* __restrict__ wv, float* __restrict__ qkv, int B,
               int Lq, int Lk, int D, int H, int dk, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nct = (H * dk + kPBN - 1) / kPBN;
  const int ct = blockIdx.x % (3 * nct), rt = blockIdx.x / (3 * nct);
  const int which = ct / nct, n0 = (ct % nct) * kPBN, row0 = rt * kPBM;
  const size_t q_size = (size_t)B * H * Lq * dk;
  const size_t kv_size = (size_t)B * H * Lk * dk;
  if (which == 0) {
    if (row0 >= B * Lq) return;
    project_tile<TQ, TW>(q_in, wq, qkv, Lq, B * Lq, row0, n0, D, H, dk,
                         inv_temp, smem);
  } else {
    if (row0 >= B * Lk) return;
    project_tile<float, TW>(kv_in, which == 1 ? wk : wv,
                            qkv + q_size + (which - 1) * kv_size, Lk, B * Lk,
                            row0, n0, D, H, dk, 1.f, smem);
  }
}

// ---------------------------------------------------------------------------
// Launch 2: per (batch element, head) softmax attention from the scratch,
// on the tensor cores with the same split (Q, K, V and P are all fp32, so
// each product is 3xTF32). Four warps, each 16 query rows: the scores and
// the probabilities stay in registers, since an m16n8 accumulator tile is,
// under the permuted k index, the A fragment of the next product.
// ---------------------------------------------------------------------------
constexpr int kRows = 64;           // max Lq / Lk / d_k handled by one block
constexpr int kCoreThreads = 128;
constexpr int kQKLd = kRows + 8;    // Q, K as [row][d]: pairs as 64-bit loads
constexpr int kVLd = kRows + 4;     // V as [key][d]: two keys per fragment

size_t core_smem_bytes() {
  return sizeof(float) * kRows * (2 * kQKLd + kVLd);
}

__global__ void __launch_bounds__(kCoreThreads)
mha_core_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, int B,
                int Lq, int Lk, int H, int dk) {
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + kRows * kQKLd;
  float* Vs = Ks + kRows * kQKLd;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HD = H * dk;
  const int tid = threadIdx.x;
  const float* q = qkv + (size_t)blockIdx.x * Lq * dk;
  const float* k =
      qkv + (size_t)B * H * Lq * dk + (size_t)blockIdx.x * Lk * dk;
  const float* v = k + (size_t)B * H * Lk * dk;
  const int ndt = (dk + 7) / 8;   // 8-wide steps of d
  const int nkt = (Lk + 7) / 8;   // 8-wide steps of the keys
  // all 64 rows and d up to 8 * ndt; rows past Lq / Lk and columns past dk
  // are zeros (a zero V row keeps a masked key's 0 * V finite)
  const int nch = 2 * ndt;  // float4 chunks of a row
  for (int idx = tid; idx < kRows * nch; idx += kCoreThreads) {
    const int r = idx / nch, d = (idx - r * nch) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 fq = z, fk = z, fv = z;
    if (d < dk) {
      if (r < Lq) fq = *reinterpret_cast<const float4*>(q + r * dk + d);
      if (r < Lk) {
        fk = *reinterpret_cast<const float4*>(k + r * dk + d);
        fv = *reinterpret_cast<const float4*>(v + r * dk + d);
      }
    }
    *reinterpret_cast<float4*>(&Qs[r * kQKLd + d]) = fq;
    *reinterpret_cast<float4*>(&Ks[r * kQKLd + d]) = fk;
    *reinterpret_cast<float4*>(&Vs[r * kVLd + d]) = fv;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  if (r0 >= Lq) return;  // no barrier follows

  // scores: s[j] is the m16n8 tile of keys 8j .. 8j+7 (q is pre-scaled)
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int kk = 0; kk < ndt; ++kk) {
    const float* p = Qs + (r0 + g) * kQKLd + kk * 8 + 2 * t;
    const float2 x0 = load2(p), x1 = load2(p + 8 * kQKLd);
    uint32_t ah[4], al[4];
    split_tf32<true>(x0.x, ah[0], al[0]);
    split_tf32<true>(x1.x, ah[1], al[1]);
    split_tf32<true>(x0.y, ah[2], al[2]);
    split_tf32<true>(x1.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
        const float2 y = load2(Ks + (j * 8 + g) * kQKLd + kk * 8 + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32<true>(y.x, bh[0], bl[0]);
        split_tf32<true>(y.y, bh[1], bl[1]);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(c, al, bh[0], bh[1]);
        mma_tf32(c, ah, bl[0], bl[1]);
        mma_tf32(c, ah, bh[0], bh[1]);
        add4(s[j], c);
      }
    }
  }

  // key columns >= Lk masked; row softmax over the four lanes of a row
  // (rows g: elements 0, 1; rows g + 8: elements 2, 3)
  float m[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j * 8 + 2 * t + (e & 1) >= Lk) s[j][e] = -1e9f;
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];

  // ctx_h = P V: the k index runs over keys, P's tile j is the A fragment
  // {c0, c2, c1, c3}; o[n] is the tile of d = 8n .. 8n+7
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nkt) {
      uint32_t ah[4], al[4];
      split_tf32<true>(s[j][0], ah[0], al[0]);
      split_tf32<true>(s[j][2], ah[1], al[1]);
      split_tf32<true>(s[j][1], ah[2], al[2]);
      split_tf32<true>(s[j][3], ah[3], al[3]);
      const float* p = Vs + (j * 8 + 2 * t) * kVLd + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < ndt) {
          uint32_t bh[2], bl[2];
          split_tf32<true>(p[n * 8], bh[0], bl[0]);
          split_tf32<true>(p[n * 8 + kVLd], bh[1], bl[1]);
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(c, al, bh[0], bh[1]);
          mma_tf32(c, ah, bl[0], bl[1]);
          mma_tf32(c, ah, bh[0], bh[1]);
          add4(o[n], c);
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= Lq) continue;
    float* dst = ctx + ((size_t)b * Lq + r) * HD + h * dk;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < dk)
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 3: output projection + residual + LayerNorm, 64 rows x all D
// columns per block. With fp32 weights the warps are 1 x 8 (each splits the
// same A rows, but its own W columns once); with bf16 weights, which need no
// split, 2 x 4, so that each warp splits half the A rows.
// ---------------------------------------------------------------------------
constexpr int kOutRows = 64;

template <typename TQ, typename TW, int NC>
__global__ void __launch_bounds__(kThreads)
mha_out_ln_kernel(const float* __restrict__ ctx, const TQ* __restrict__ q_in,
                  const TW* __restrict__ wo, const TW* __restrict__ ln_scale,
                  const TW* __restrict__ ln_bias, float* __restrict__ out,
                  int R, int HD) {
  constexpr int D = 128 * NC;
  constexpr int WN = std::is_same<TW, float>::value ? 8 : 4;
  constexpr int MT = WN / 2, NT = D / (8 * WN);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WN][kOutRows];  // per-warp row partials

  const int row0 = blockIdx.x * kOutRows;
  float acc[MT][NT][4];
  gemm_tile<float, TW, kOutRows, D, WN, MT, NT, 1>(
      ctx + (size_t)row0 * HD, HD, R - row0, wo, HD, D, HD, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * MT * 16, wc = (warp % WN) * NT * 8;
  const float inv_d = 1.f / (float)D;

  // the residual; rows past R stay zero and are not stored
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wr + i * 16 + g + 8 * half;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 x = load2(q_in + (size_t)r * D + wc + j * 8 + 2 * t);
        acc[i][j][2 * half] += x.x;
        acc[i][j][2 * half + 1] += x.y;
      }
    }

  // row sums over the warp's columns (the four lanes of a row, then the WN
  // warps of the row through shared memory): first the mean, then the
  // variance
  float mean[MT][2], rstd[MT][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float o = acc[i][j][2 * half + e];
            if (pass == 0) {
              s += o;
            } else {
              const float d = o - mean[i][half];
              s = fmaf(d, d, s);
            }
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[warp % WN][wr + i * 16 + g + 8 * half] = s;
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WN; ++w) s += red[w][wr + i * 16 + g + 8 * half];
        if (pass == 0)
          mean[i][half] = s * inv_d;
        else
          rstd[i][half] = 1.f / sqrtf(s * inv_d + 1e-6f);
      }
    __syncthreads();  // red is written again by the next pass
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = wc + j * 8 + 2 * t;
    const float2 sc = load2(ln_scale + c), bi = load2(ln_bias + c);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wr + i * 16 + g + 8 * half;
        if (r >= R) continue;
        const float m = mean[i][half], rs = rstd[i][half];
        *reinterpret_cast<float2*>(&out[(size_t)r * D + c]) = make_float2(
            (acc[i][j][2 * half] - m) * rs * sc.x + bi.x,
            (acc[i][j][2 * half + 1] - m) * rs * sc.y + bi.y);
      }
  }
}

template <typename TQ, typename TW>
void launch_qkv(const void* q_in, const void* kv_in, const void* wq,
                const void* wk, const void* wv, float* qkv, int B, int Lq,
                int Lk, int D, int H, int dk, cudaStream_t stream) {
  // the Q tiles stage TQ rows, the K and V tiles fp32 rows: the ring of
  // either must fit
  const size_t smem_q = gemm_smem_bytes<TQ, TW, kPBM, kPBN, kPBlocks>();
  const size_t smem_kv = gemm_smem_bytes<float, TW, kPBM, kPBN, kPBlocks>();
  const size_t smem = smem_q > smem_kv ? smem_q : smem_kv;
  auto kern = mha_qkv_kernel<TQ, TW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int nct = (H * dk + kPBN - 1) / kPBN;
  const int rows = B * (Lq > Lk ? Lq : Lk);
  const int blocks = 3 * nct * ((rows + kPBM - 1) / kPBM);
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q_in), static_cast<const float*>(kv_in),
      static_cast<const TW*>(wq), static_cast<const TW*>(wk),
      static_cast<const TW*>(wv), qkv, B, Lq, Lk, D, H, dk,
      1.f / sqrtf((float)dk));
}

void launch_core(const float* qkv, float* ctx, int B, int Lq, int Lk, int H,
                 int dk, cudaStream_t stream) {
  const size_t smem = core_smem_bytes();
  cudaFuncSetAttribute(mha_core_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  mha_core_kernel<<<B * H, kCoreThreads, smem, stream>>>(qkv, ctx, B, Lq, Lk,
                                                         H, dk);
}

template <typename TQ, typename TW, int NC>
void launch_out(const float* ctx, const void* q_in, const void* wo,
                const void* s, const void* bi, float* out, int R, int HD,
                cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes<float, TW, kOutRows, 128 * NC, 1>();
  auto kern = mha_out_ln_kernel<TQ, TW, NC>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (R + kOutRows - 1) / kOutRows;
  kern<<<blocks, kThreads, smem, stream>>>(
      ctx, static_cast<const TQ*>(q_in), static_cast<const TW*>(wo),
      static_cast<const TW*>(s), static_cast<const TW*>(bi), out, R, HD);
}

template <typename TQ, typename TW>
void launch_out_nc(int nc, const float* ctx, const void* q_in, const void* wo,
                   const void* s, const void* bi, float* out, int R, int HD,
                   cudaStream_t st) {
  switch (nc) {
    case 1: launch_out<TQ, TW, 1>(ctx, q_in, wo, s, bi, out, R, HD, st); break;
    case 2: launch_out<TQ, TW, 2>(ctx, q_in, wo, s, bi, out, R, HD, st); break;
    case 3: launch_out<TQ, TW, 3>(ctx, q_in, wo, s, bi, out, R, HD, st); break;
    default: launch_out<TQ, TW, 4>(ctx, q_in, wo, s, bi, out, R, HD, st); break;
  }
}

template <typename TQ, typename TW>
void launch_all(const void* q_in, const void* kv_in, const void* wq,
                const void* wk, const void* wv, const void* wo, const void* s,
                const void* bi, float* qkv, float* ctx, float* out, int B,
                int Lq, int Lk, int D, int H, int dk, cudaStream_t st) {
  launch_qkv<TQ, TW>(q_in, kv_in, wq, wk, wv, qkv, B, Lq, Lk, D, H, dk, st);
  launch_core(qkv, ctx, B, Lq, Lk, H, dk, st);
  launch_out_nc<TQ, TW>(D / 128, ctx, q_in, wo, s, bi, out, B * Lq, H * dk,
                        st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Shapes: q_in (B, Lq, D),
// kv_in (B, Lk, D) float32, wq/wk/wv (H*dk, D), wo (D, H*dk), ln_scale/ln_bias
// (D,), qkv scratch B*H*(Lq + 2*Lk)*dk fp32, ctx scratch (B, Lq, H*dk) fp32,
// out (B, Lq, D) fp32. The caller checks Lq, Lk, dk <= 64, dk % 4 == 0,
// D % 128 == 0, D <= 512, (H*dk) % 32 == 0, and 16-byte aligned pointers.
extern "C" int eg_attention(const void* q_in, int q_bf16, const void* kv_in,
                            const void* wq, const void* wk, const void* wv,
                            const void* wo, const void* ln_scale,
                            const void* ln_bias, int w_bf16, void* qkv,
                            void* ctx, void* out, int B, int Lq, int Lk, int D,
                            int H, int dk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(qkv);
  float* c = static_cast<float*>(ctx);
  float* o = static_cast<float*>(out);
  using bf16 = __nv_bfloat16;
  if (q_bf16 && w_bf16)
    launch_all<bf16, bf16>(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias, s,
                           c, o, B, Lq, Lk, D, H, dk, st);
  else if (q_bf16)
    launch_all<bf16, float>(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias, s,
                            c, o, B, Lq, Lk, D, H, dk, st);
  else if (w_bf16)
    launch_all<float, bf16>(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias, s,
                            c, o, B, Lq, Lk, D, H, dk, st);
  else
    launch_all<float, float>(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias,
                             s, c, o, B, Lq, Lk, D, H, dk, st);
  return (int)cudaGetLastError();
}
