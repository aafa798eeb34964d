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
// in fp32 arithmetic whatever the input types: the query (fp32 or bf16), the
// keys/values (fp32) and the weights (fp32 or bf16) are read as they are and
// widened on load (bf16 -> fp32 is exact), so the sums equal the TPU kernel's
// fp32-accumulated dots. Output is fp32. These are the types the serving path
// gives it: fp32 throughout, or under bf16 serving fp32 activations (a bf16
// query in the first decoder layer) with bf16 weights.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): compute. At B=1024,
// L=60, d_model=512 the sublayer does ~136 GFLOP of fp32 FMA (128.8
// projections + 7.5 attention) and moves 0.25 GB (self-attention) to 0.38 GB
// (cross, fp32), so 67 TFLOP/s of fp32 (non-tensor-core) gives ~2.0 ms
// against at most ~0.11 ms of memory time.
//
// Design (simple first version, two launches per sublayer):
//   1. mha_heads_kernel, one block per (batch element, head): the head's
//      Q/K/V projections as register-blocked SGEMM tiles from global memory,
//      the (<=64)x(<=64) scores, softmax and ctx_h in shared memory, ctx_h
//      written to an fp32 scratch tensor (B, Lq, H*d_k).
//   2. mha_out_ln_kernel, one block per 32 rows: output projection over the
//      full d_model row, residual add and LayerNorm with warp reductions.
// Key columns >= Lk are masked by index, so no padding to 64 rows is needed.
//
// C interface (loaded with ctypes): eg_attention(...) returns the
// cudaGetLastError() code after its launches; 0 means both launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // max Lq / Lk / d_k handled by one block
constexpr int kBK = 32;        // k-depth of a projection tile
constexpr int kQKVStride = 68; // padded row stride of the Q/K/V tiles
constexpr int kSStride = 65;   // padded row stride of the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive elements as floats. p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

// ---------------------------------------------------------------------------
// Launch 1: per (batch element, head) projections + softmax attention.
// ---------------------------------------------------------------------------
template <typename TQ, typename TW>
__global__ void __launch_bounds__(kThreads)
mha_heads_kernel(const TQ* __restrict__ q_in, const float* __restrict__ kv_in,
                 const TW* __restrict__ wq, const TW* __restrict__ wk,
                 const TW* __restrict__ wv, float* __restrict__ ctx, int Lq,
                 int Lk, int D, int H, int dk, float inv_temp) {
  extern __shared__ float smem[];
  // region A: five transposed [kBK][64] tiles, later the score tile
  float* tQ = smem;
  float* tKV = tQ + kBK * kRows;
  float* tWq = tKV + kBK * kRows;
  float* tWk = tWq + kBK * kRows;
  float* tWv = tWk + kBK * kRows;
  float* S = smem;  // [64][kSStride], used after the projection only
  // region B: Q^T and K^T as [d][row], V as [row][d]
  float* QT = smem + 5 * kBK * kRows;
  float* KT = QT + kRows * kQKVStride;
  float* Vs = KT + kRows * kQKVStride;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HD = H * dk;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // loader: row lr (0..63), eight k values from lk
  const int lr = tid >> 2, lk = (tid & 3) * 8;
  const bool q_ok = lr < Lq, kv_ok = lr < Lk, w_ok = lr < dk;
  const TQ* qrow = q_in + ((size_t)b * Lq + (q_ok ? lr : 0)) * D;
  const float* kvrow = kv_in + ((size_t)b * Lk + (kv_ok ? lr : 0)) * D;
  const size_t wrow = (size_t)(h * dk + (w_ok ? lr : 0)) * D;

  float rq[8], rkv[8], rwq[8], rwk[8], rwv[8];
  auto gload = [&](int k0) {
    if (q_ok) load8(qrow + k0 + lk, rq); else zero8(rq);
    if (kv_ok) load8(kvrow + k0 + lk, rkv); else zero8(rkv);
    if (w_ok) {
      load8(wq + wrow + k0 + lk, rwq);
      load8(wk + wrow + k0 + lk, rwk);
      load8(wv + wrow + k0 + lk, rwv);
    } else {
      zero8(rwq); zero8(rwk); zero8(rwv);
    }
  };

  float aq[4][4], ak[4][4], av[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) aq[i][j] = ak[i][j] = av[i][j] = 0.f;

  gload(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (lk + i) * kRows + lr;
      tQ[o] = rq[i];
      tKV[o] = rkv[i];
      tWq[o] = rwq[i];
      tWk[o] = rwk[i];
      tWv[o] = rwv[i];
    }
    __syncthreads();
    if (k0 + kBK < D) gload(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 xq = *reinterpret_cast<const float4*>(&tQ[kk * kRows + ty * 4]);
      const float4 xk = *reinterpret_cast<const float4*>(&tKV[kk * kRows + ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&tWq[kk * kRows + tx * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&tWk[kk * kRows + tx * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&tWv[kk * kRows + tx * 4]);
      const float a1[4] = {xq.x, xq.y, xq.z, xq.w};
      const float a2[4] = {xk.x, xk.y, xk.z, xk.w};
      const float b1[4] = {bq.x, bq.y, bq.z, bq.w};
      const float b2[4] = {bk.x, bk.y, bk.z, bk.w};
      const float b3[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          aq[i][j] = fmaf(a1[i], b1[j], aq[i][j]);
          ak[i][j] = fmaf(a2[i], b2[j], ak[i][j]);
          av[i][j] = fmaf(a2[i], b3[j], av[i][j]);
        }
    }
  }

  // rows ty*4+i, head columns tx*4+j; q is scaled as the TPU kernel does
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx * 4 + j;
      QT[c * kQKVStride + r] = aq[i][j] * inv_temp;
      KT[c * kQKVStride + r] = ak[i][j];
      Vs[r * kQKVStride + c] = av[i][j];
    }
  __syncthreads();  // also retires every read of region A

  // scores S[i][j] = sum_d Q[i][d] K[j][d]; columns >= Lk masked
  {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&QT[d * kQKVStride + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&KT[d * kQKVStride + tx * 4]);
      const float a[4] = {qa.x, qa.y, qa.z, qa.w};
      const float c[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        S[(ty * 4 + i) * kSStride + col] = col < Lk ? s[i][j] : -1e9f;
      }
  }
  __syncthreads();

  // row softmax: warp w takes rows w*8 .. w*8+7, lanes take two columns
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int rr = 0; rr < 8; ++rr) {
      float* row = S + (warp * 8 + rr) * kSStride;
      const float v0 = row[lane], v1 = row[lane + 32];
      float m = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e0 = expf(v0 - m), e1 = expf(v1 - m);
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row[lane] = e0 / sum;
      row[lane + 32] = e1 / sum;
    }
  }
  __syncthreads();

  // ctx_h[i][d] = sum_{j < Lk} P[i][j] V[j][d]
  {
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float4 vb = *reinterpret_cast<const float4*>(&Vs[j * kQKVStride + tx * 4]);
      const float v[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = S[(ty * 4 + i) * kSStride + j];
#pragma unroll
        for (int d = 0; d < 4; ++d) c[i][d] = fmaf(p, v[d], c[i][d]);
      }
    }
    const int d0 = tx * 4;
    if (d0 < dk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r < Lq) {
          float4 o = make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
          *reinterpret_cast<float4*>(&ctx[((size_t)b * Lq + r) * HD + h * dk + d0]) = o;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2: output projection + residual + LayerNorm, 32 rows per block.
// Warp w owns rows w*4..w*4+3; lane owns columns lane*4 + 128*c, c < NC.
// ---------------------------------------------------------------------------
constexpr int kOutRows = 32;
constexpr int kOutBK = 16;

template <typename TQ, typename TW, int NC>
__global__ void __launch_bounds__(kThreads)
mha_out_ln_kernel(const float* __restrict__ ctx, const TQ* __restrict__ q_in,
                  const TW* __restrict__ wo, const TW* __restrict__ ln_scale,
                  const TW* __restrict__ ln_bias, float* __restrict__ out,
                  int R, int HD) {
  constexpr int D = 128 * NC;
  __shared__ __align__(16) float sA[kOutBK][kOutRows];
  __shared__ __align__(16) float sB[kOutBK][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kOutRows;

  // A loader: row ar, two k values from ak
  const int ar = tid >> 3, ak = (tid & 7) * 2;
  const bool a_ok = row0 + ar < R;
  const float* arow = ctx + (size_t)(a_ok ? row0 + ar : 0) * HD;
  // B loader: weight rows tid + 256*m (m < NC/2 rounded up), 16 k values
  constexpr int kBRows = (D + kThreads - 1) / kThreads;

  float ra[2];
  float rb[kBRows][16];
  auto gload = [&](int k0) {
    if (a_ok) {
      const float2 v = *reinterpret_cast<const float2*>(arow + k0 + ak);
      ra[0] = v.x; ra[1] = v.y;
    } else {
      ra[0] = ra[1] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < kBRows; ++m) {
      const int n = tid + kThreads * m;
      if (n < D) {
        float t[8];
        load8(wo + (size_t)n * HD + k0, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) rb[m][i] = t[i];
        load8(wo + (size_t)n * HD + k0 + 8, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) rb[m][8 + i] = t[i];
      }
    }
  };

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;

  gload(0);
  for (int k0 = 0; k0 < HD; k0 += kOutBK) {
    __syncthreads();
    sA[ak][ar] = ra[0];
    sA[ak + 1][ar] = ra[1];
#pragma unroll
    for (int m = 0; m < kBRows; ++m) {
      const int n = tid + kThreads * m;
      if (n < D) {
#pragma unroll
        for (int i = 0; i < 16; ++i) sB[i][n] = rb[m][i];
      }
    }
    __syncthreads();
    if (k0 + kOutBK < HD) gload(k0 + kOutBK);
#pragma unroll
    for (int kk = 0; kk < kOutBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sA[kk][warp * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sB[kk][c * 128 + lane * 4]);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][c * 4 + j] = fmaf(a[i], bb[j], acc[i][c * 4 + j]);
      }
    }
  }

  // residual + LayerNorm over the D columns of each row (one warp per row)
  const float inv_d = 1.f / (float)D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp * 4 + i;
    const bool ok = r < R;  // warp-uniform
    if (!ok) continue;
    const TQ* xrow = q_in + (size_t)r * D;
    float o[4 * NC];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * 128 + lane * 4 + j;
        o[c * 4 + j] = acc[i][c * 4 + j] + to_f(xrow[col]);
        sum += o[c * 4 + j];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) {
      const float d = o[j] - mean;
      sq = fmaf(d, d, sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = 1.f / sqrtf(sq * inv_d + 1e-6f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col0 = c * 128 + lane * 4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = (o[c * 4 + j] - mean) * rstd * to_f(ln_scale[col0 + j]) +
               to_f(ln_bias[col0 + j]);
      *reinterpret_cast<float4*>(&out[(size_t)r * D + col0]) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

size_t heads_smem_bytes() {
  return sizeof(float) * (5 * kBK * kRows + 3 * kRows * kQKVStride);
}

template <typename TQ, typename TW>
void launch_heads(const void* q_in, const void* kv_in, const void* wq,
                  const void* wk, const void* wv, float* ctx, int B, int Lq,
                  int Lk, int D, int H, int dk, cudaStream_t stream) {
  const size_t smem = heads_smem_bytes();
  auto kern = mha_heads_kernel<TQ, TW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const float inv_temp = 1.f / sqrtf((float)dk);
  kern<<<B * H, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q_in), static_cast<const float*>(kv_in),
      static_cast<const TW*>(wq), static_cast<const TW*>(wk),
      static_cast<const TW*>(wv), ctx, Lq, Lk, D, H, dk, inv_temp);
}

template <typename TQ, typename TW, int NC>
void launch_out(const float* ctx, const void* q_in, const void* wo,
                const void* s, const void* bi, float* out, int R, int HD,
                cudaStream_t stream) {
  const int blocks = (R + kOutRows - 1) / kOutRows;
  mha_out_ln_kernel<TQ, TW, NC><<<blocks, kThreads, 0, stream>>>(
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

template <typename TQ>
void dispatch_w(int w_bf16, const void* q_in, const void* kv_in,
                const void* wq, const void* wk, const void* wv,
                const void* wo, const void* s, const void* bi, float* ctx,
                float* out, int B, int Lq, int Lk, int D, int H, int dk,
                cudaStream_t st) {
  const int nc = D / 128;
  if (w_bf16) {
    launch_heads<TQ, __nv_bfloat16>(q_in, kv_in, wq, wk, wv, ctx, B, Lq, Lk,
                                    D, H, dk, st);
    launch_out_nc<TQ, __nv_bfloat16>(nc, ctx, q_in, wo, s, bi, out, B * Lq,
                                     H * dk, st);
  } else {
    launch_heads<TQ, float>(q_in, kv_in, wq, wk, wv, ctx, B, Lq, Lk, D, H,
                            dk, st);
    launch_out_nc<TQ, float>(nc, ctx, q_in, wo, s, bi, out, B * Lq, H * dk,
                             st);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Shapes: q_in (B, Lq, D),
// kv_in (B, Lk, D) float32, wq/wk/wv (H*dk, D), wo (D, H*dk), ln_scale/ln_bias (D,),
// ctx scratch (B, Lq, H*dk) fp32, out (B, Lq, D) fp32. The caller checks
// Lq, Lk, dk <= 64, dk % 4 == 0, D % 128 == 0, D <= 512, (H*dk) % 32 == 0.
extern "C" int eg_attention(const void* q_in, int q_bf16, const void* kv_in,
                            const void* wq, const void* wk,
                            const void* wv, const void* wo,
                            const void* ln_scale, const void* ln_bias,
                            int w_bf16, void* ctx, void* out, int B, int Lq,
                            int Lk, int D, int H, int dk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* c = static_cast<float*>(ctx);
  float* o = static_cast<float*>(out);
  if (q_bf16)
    dispatch_w<__nv_bfloat16>(w_bf16, q_in, kv_in, wq, wk, wv, wo, ln_scale,
                              ln_bias, c, o, B, Lq, Lk, D, H, dk, st);
  else
    dispatch_w<float>(w_bf16, q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias,
                      c, o, B, Lq, Lk, D, H, dk, st);
  return (int)cudaGetLastError();
}
