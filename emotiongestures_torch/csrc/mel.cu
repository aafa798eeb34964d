// Fused power mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel emotiongestures_tpu/ops/pallas_mel.py (_mel_kernel,
// driven by melspectrogram_pallas / batched_melspectrogram_pallas /
// extract_melspectrogram_pallas). Per frame of 1024 samples:
//
//     x = frame * hann                        (periodic window)
//     re = x @ DFT_cos, im = x @ DFT_-sin     (513 rFFT bins)
//     power = re^2 + im^2
//     mel = power @ FB                        (Slaney filterbank, 513 x 128)
//
// all in fp32 FMA (not TF32: its ~3 digits would eat the 2e-3 tolerance the
// TPU kernel is held to). The frames are gathered here from the reflect-padded
// waves (frame f of clip c starts at c*clip_stride + f*hop), so the (T, 1024)
// frame matrix, which overlaps itself twice at hop 512, never goes to device
// memory; neither does the (T, 513) power.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. At 1024 clips x
// 126 frames = 129,024 frames the function's least work (window, a real FFT
// of ~2.5 N log2 N, |X|^2, the filterbank over its ~1,000 nonzeros) is ~3.9
// GFLOP, ~0.06 ms at 67 TFLOP/s of fp32, against ~0.1 ms to read the waves
// (0.27 GB) and write the mel (0.07 GB) at 3.35 TB/s. This design does far
// more: the DFT as two dense products, 2*T*1024*513*2 ~ 271 GFLOP, and the
// dense filterbank product, 2*T*513*128 ~ 17 GFLOP, so it cannot beat ~4.3
// ms of fp32 FMA. An FFT-based kernel is the way to the bound.
//
// Design (simple first version): one block of 256 threads per 128 frames.
// For each tile of 64 bins (bins 0..511, eight tiles) a register-blocked
// SGEMM accumulates re and im (8 frames x 4 bins of each per thread) over
// k = 1024 from shared-memory tiles; the tile's power goes to shared memory
// and is multiplied at once into the block's 128 x 128 mel accumulator, which
// stays in registers (8 x 8 per thread). The Nyquist bin 512 is one extra
// dot product per frame, so the 513 real bins are computed with no padding.
//
// C interface (loaded with ctypes): eg_mel(...) returns the
// cudaGetLastError() code after its launch; 0 means it launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNFFT = 1024;
constexpr int kMainBins = 512;  // bins 0..511; bin 512 (Nyquist) apart
constexpr int kMels = 128;
constexpr int kBM = 128;  // frames per block
constexpr int kBN = 64;   // bins per tile
constexpr int kBK = 16;   // samples per k step

__global__ void __launch_bounds__(kThreads, 1)
mel_kernel(const float* __restrict__ wave, long long clip_stride,
           int frames_per_clip, int hop, int total_frames,
           const float* __restrict__ win, const float* __restrict__ cosm,
           const float* __restrict__ sinm, const float* __restrict__ cos_nyq,
           const float* __restrict__ sin_nyq, const float* __restrict__ fb,
           float* __restrict__ out) {
  extern __shared__ float smem[];
  float* As = smem;                  // [kBK][kBM] windowed frames, transposed
  float* Cs = As + kBK * kBM;        // [kBK][kBN] cos tile
  float* Ss = Cs + kBK * kBN;        // [kBK][kBN] -sin tile
  float* P = Ss + kBK * kBN;         // [kBN][kBM] power, bin-major
  float* Pn = P + kBN * kBM;         // [kBM] Nyquist power
  float* Win = Pn + kBM;             // [kNFFT] window

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int g_base = blockIdx.x * kBM;

  for (int i = tid; i < kNFFT; i += kThreads) Win[i] = win[i];

  // A loader: rows ar and ar + 64, four samples from ak
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const float* arow[2];
  bool a_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = g_base + ar + 64 * h;
    a_ok[h] = g < total_frames;
    const int gc = a_ok[h] ? g : 0;
    arow[h] = wave + (long long)(gc / frames_per_clip) * clip_stride +
              (long long)(gc % frames_per_clip) * hop;
  }
  // B loader: sample row bk, four bins from bn
  const int bk = tid >> 4, bn = (tid & 15) * 4;

  float mel[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mel[i][j] = 0.f;

  float4 ra[2], rc, rs;
  for (int j0 = 0; j0 < kMainBins; j0 += kBN) {
    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    auto gload = [&](int k0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ra[h] = a_ok[h] ? *reinterpret_cast<const float4*>(arow[h] + k0 + ak)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      const size_t o = (size_t)(k0 + bk) * kMainBins + j0 + bn;
      rc = *reinterpret_cast<const float4*>(cosm + o);
      rs = *reinterpret_cast<const float4*>(sinm + o);
    };

    gload(0);
    for (int k0 = 0; k0 < kNFFT; k0 += kBK) {
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ar + 64 * h;
        As[(ak + 0) * kBM + r] = ra[h].x * Win[k0 + ak + 0];
        As[(ak + 1) * kBM + r] = ra[h].y * Win[k0 + ak + 1];
        As[(ak + 2) * kBM + r] = ra[h].z * Win[k0 + ak + 2];
        As[(ak + 3) * kBM + r] = ra[h].w * Win[k0 + ak + 3];
      }
      *reinterpret_cast<float4*>(&Cs[bk * kBN + bn]) = rc;
      *reinterpret_cast<float4*>(&Ss[bk * kBN + bn]) = rs;
      __syncthreads();
      if (k0 + kBK < kNFFT) gload(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * kBM + ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * kBM + ty * 8 + 4]);
        const float4 c4 = *reinterpret_cast<const float4*>(&Cs[kk * kBN + tx * 4]);
        const float4 s4 = *reinterpret_cast<const float4*>(&Ss[kk * kBN + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], c[j], re[i][j]);
            im[i][j] = fmaf(a[i], s[j], im[i][j]);
          }
      }
    }

    // power of this bin tile -> P[bin][frame]; the previous tile's readers
    // of P have all passed the k loop's barriers by now
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        P[(tx * 4 + j) * kBM + ty * 8 + i] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
    __syncthreads();

    // mel[frame][m] += sum_bin P[bin][frame] * fb[j0 + bin][m]
#pragma unroll 4
    for (int kb = 0; kb < kBN; ++kb) {
      const float4 p0 = *reinterpret_cast<const float4*>(&P[kb * kBM + ty * 8]);
      const float4 p1 = *reinterpret_cast<const float4*>(&P[kb * kBM + ty * 8 + 4]);
      const float* frow = fb + (size_t)(j0 + kb) * kMels + tx * 8;
      const float4 f0 = __ldg(reinterpret_cast<const float4*>(frow));
      const float4 f1 = __ldg(reinterpret_cast<const float4*>(frow + 4));
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < 8; ++m) mel[i][m] = fmaf(p[i], f[m], mel[i][m]);
    }
  }

  // Nyquist bin: warp w takes frames w*16 .. w*16+15
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int g = g_base + r;
      float pw = 0.f;
      if (g < total_frames) {  // warp-uniform
        const float* frame = wave +
                             (long long)(g / frames_per_clip) * clip_stride +
                             (long long)(g % frames_per_clip) * hop;
        float sre = 0.f, sim = 0.f;
        for (int k = lane; k < kNFFT; k += 32) {
          const float x = frame[k] * Win[k];
          sre = fmaf(x, cos_nyq[k], sre);
          sim = fmaf(x, sin_nyq[k], sim);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sre += __shfl_xor_sync(0xffffffffu, sre, off);
          sim += __shfl_xor_sync(0xffffffffu, sim, off);
        }
        pw = sre * sre + sim * sim;
      }
      if (lane == 0) Pn[r] = pw;
    }
  }
  __syncthreads();

  const float* fnyq = fb + (size_t)kMainBins * kMels + tx * 8;
  float fn[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) fn[m] = fnyq[m];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = g_base + ty * 8 + i;
    if (g >= total_frames) continue;
    const float pn = Pn[ty * 8 + i];
    float y[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) y[m] = fmaf(pn, fn[m], mel[i][m]);
    float* orow = out + (size_t)g * kMels + tx * 8;
    *reinterpret_cast<float4*>(orow) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(orow + 4) = make_float4(y[4], y[5], y[6], y[7]);
  }
}

size_t smem_bytes() {
  return sizeof(float) *
         (kBK * kBM + 2 * kBK * kBN + kBN * kBM + kBM + kNFFT);
}

}  // namespace

// wave: (n_clips, clip_stride) fp32, reflect-padded clips, clip_stride and
// hop multiples of 4; win (1024,); cosm, sinm (1024, 512) row-major, bins
// 0..511 of the cos and -sin DFT matrices; cos_nyq, sin_nyq (1024,), bin 512;
// fb (513, 128), the transposed filterbank; out (total_frames, 128) fp32.
extern "C" int eg_mel(const void* wave, long long clip_stride,
                      int frames_per_clip, int hop, int total_frames,
                      const void* win, const void* cosm, const void* sinm,
                      const void* cos_nyq, const void* sin_nyq,
                      const void* fb, void* out, void* stream) {
  const size_t smem = smem_bytes();
  cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (total_frames + kBM - 1) / kBM;
  mel_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), clip_stride, frames_per_clip, hop,
      total_frames, static_cast<const float*>(win),
      static_cast<const float*>(cosm), static_cast<const float*>(sinm),
      static_cast<const float*>(cos_nyq), static_cast<const float*>(sin_nyq),
      static_cast<const float*>(fb), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
