// Fused power mel spectrogram for Hopper (sm_90a): a real FFT in shared
// memory and a banded filterbank.
//
// Replaces the TPU kernel emotiongestures_tpu/ops/pallas_mel.py (_mel_kernel,
// driven by melspectrogram_pallas / batched_melspectrogram_pallas /
// extract_melspectrogram_pallas). Per frame of 1024 samples:
//
//     x = frame * hann                        (periodic window)
//     X = rfft(x)                             (513 bins)
//     power = |X|^2
//     mel = power @ FB                        (Slaney filterbank, 513 x 128)
//
// all in fp32. The TPU kernel computes the rFFT as two dense GEMMs against
// cos and -sin matrices, the right choice for its matrix unit; outside the
// tensor cores that is ~75x the arithmetic of an FFT, and the dense
// filterbank product ~65x that of the filterbank's 1,009 nonzeros.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. At 1024 clips x
// 126 frames = 129,024 frames the function's least work (window, a real FFT
// of ~2.5 N log2 N, |X|^2, the filterbank over its nonzeros) is ~3.9 GFLOP,
// ~0.06 ms at 67 TFLOP/s of fp32, against ~0.1 ms to read the padded waves
// (0.27 GB) and write the mel (0.07 GB) at 3.35 TB/s. This design does about
// that least work (~3.5 GFLOP); what it adds is shared-memory traffic, ~36 KB
// a frame (~4.7 GB in all), and a barrier between its passes.
//
// Design. One block per (clip, tile of kTile = 8 consecutive frames), 256
// threads; a 1-D grid over every clip's tiles, a clip's tiles side by side,
// so a block never straddles two clips and neither the clips nor the tiles
// are held to the 65535 of a grid's y dimension. The last tile of a clip is
// masked. Tiles of 16 frames (two blocks per SM) were slower on the card
// than tiles of 8 (four), PERF.md has both times.
//   1. The tile's span, (kTile - 1) hop + 1024 samples, is loaded once into
//      shared memory with 16-byte cp.async copies, all in flight at once: at
//      hop 512 neighbouring frames share half their samples, and each is read
//      from device memory once.
//   2. The real 1024-point FFT is a 512-point complex FFT of
//      z[n] = x[2n] + i x[2n+1] (the window applied while packing): three
//      radix-8 Stockham passes, each butterfly's 8 values held in registers.
//      A pass reads all its inputs, waits at a barrier and writes its outputs
//      over them, so one buffer per frame suffices (no ping-pong); the
//      first pass reads straight from the span.
//   3. The split step X[k] = (Z[k] + Z*[512-k]) / 2
//                           - i W^k (Z[k] - Z*[512-k]) / 2
//      gives all 513 bins, DC and Nyquist included, each thread taking the
//      pair (k, 512 - k); |X|^2 is written over the frame's buffer.
//   4. Each thread computes a mel of a frame as a dot product over its band
//      of the filterbank (a host table of start, length and offset into the
//      1,009 packed weights), a narrow low mel and a wide high one to even
//      out the threads' work, and a frame's 128 mels go out as one
//      coalesced 512-byte row.
// The twiddles come from tables the host computes in float64 (read with
// __ldg), never from the fast __sinf/__cosf: W^k = exp(-2 pi i k / 1024) for
// the split step (k < 256), and those of the second and third passes in the
// order a warp reads them.
// Shared memory: 4 ((kTile - 1) hop + 1024) + 4.5 KB kTile bytes (the
// frames' buffers padded against bank conflicts), 54 KB at hop 512, so four
// blocks fit on an SM.
//
// C interface (loaded with ctypes): eg_mel(...) returns the
// cudaGetLastError() code after its launch; 0 means it launched.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 1024;
constexpr int kN = kNFFT / 2;  // complex FFT length
constexpr int kBfly = kN / 8;  // radix-8 butterflies per frame and pass
// a frame's 512 complex values in shared memory, one pad after every 8: the
// first two passes write with strides of 8 and 64 values, which would put a
// warp's stores on 2 (or 8) bank pairs; padded they spread over all 16
constexpr int kStride = kN + kN / 8;
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }
constexpr int kMels = 128;
constexpr int kTile = 8;                // frames per block
constexpr int kThreads = 32 * kTile;

// 16 bytes from device to shared memory without a register round trip, so
// that every load of a thread is in flight at once
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmul_neg_i(float2 a) {  // a * -i
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ void fft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

// forward 4-point DFT in place, natural order in and out
__device__ __forceinline__ void fft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  fft2(a0, a2);
  fft2(a1, a3);
  a3 = cmul_neg_i(a3);
  fft2(a0, a1);
  fft2(a2, a3);
  const float2 t = a1;  // (X0, X2, X1, X3) -> (X0, X1, X2, X3)
  a1 = a2;
  a2 = t;
}

// forward 8-point DFT in place, natural order in and out: two 4-point DFTs
// of the even and odd inputs, then one radix-2 step with W8^k
__device__ __forceinline__ void fft8(float2 (&v)[8]) {
  fft4(v[0], v[2], v[4], v[6]);
  fft4(v[1], v[3], v[5], v[7]);
  const float r = 0.70710678118654752f;
  const float2 o1 = make_float2((v[3].x + v[3].y) * r, (v[3].y - v[3].x) * r);
  const float2 o2 = cmul_neg_i(v[5]);
  const float2 o3 = make_float2((v[7].y - v[7].x) * r, -(v[7].x + v[7].y) * r);
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// One Stockham radix-8 pass over a frame's 512 values, butterfly j: inputs
// at j + 64 r, twiddled by W_{8 Ns}^{(j % Ns) r}; outputs at
// (j / Ns) 8 Ns + j % Ns + Ns r. The host lays the twiddles of passes
// Ns = 8 and 64 out as [pass][r - 1][j], so a warp's loads are contiguous.
template <int Ns>
__device__ __forceinline__ void twiddle(float2 (&v)[8], int j,
                                        const float2* __restrict__ ptw) {
  if (Ns == 1) return;
  const float2* t = ptw + (Ns == 8 ? 0 : 7 * kBfly) + j;
#pragma unroll
  for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], __ldg(t + (r - 1) * kBfly));
}

template <int Ns>
__device__ __forceinline__ int out_index(int j) {
  return (j / Ns) * 8 * Ns + j % Ns;
}

template <int Ns, int kPer>
__device__ __forceinline__ void pass_in_place(float2* __restrict__ buf,
                                              const int (&fr)[kPer], int j,
                                              const float2* __restrict__ ptw) {
  float2 v[kPer][8];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float2* src = buf + fr[p] * kStride;
#pragma unroll
    for (int r = 0; r < 8; ++r) v[p][r] = src[pad(j + kBfly * r)];
  }
  __syncthreads();  // every input read before any output overwrites it
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    twiddle<Ns>(v[p], j, ptw);
    fft8(v[p]);
    float2* dst = buf + fr[p] * kStride;
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[pad(out_index<Ns>(j) + Ns * r)] = v[p][r];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
mel_fft_kernel(const float* __restrict__ wave, long long clip_stride,
               int frames_per_clip, int hop,
               const float* __restrict__ win, const float2* __restrict__ tw,
               const float2* __restrict__ ptw, const int4* __restrict__ bands,
               const float* __restrict__ band_w, float* __restrict__ out) {
  constexpr int kPer = kTile * kBfly / kThreads;  // butterflies per thread: 2
  extern __shared__ __align__(16) float smem[];
  const int span = (kTile - 1) * hop + kNFFT;     // a multiple of 4
  float* xs = smem;                                // the tile's samples
  float2* buf = reinterpret_cast<float2*>(smem + span);  // [kTile][kStride]

  const int tid = threadIdx.x;
  const int tiles = (frames_per_clip + kTile - 1) / kTile;
  const int clip = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - clip * tiles) * kTile;
  const int nvalid = min(kTile, frames_per_clip - f0);

  // 1. the span of the tile's valid frames, 16 bytes a thread
  {
    const float4* src = reinterpret_cast<const float4*>(
        wave + (long long)clip * clip_stride + (long long)f0 * hop);
    float4* dst = reinterpret_cast<float4*>(xs);
    const int n4 = ((nvalid - 1) * hop + kNFFT) / 4;
    for (int i = tid; i < n4; i += kThreads) cp_async16(dst + i, src + i);
    cp_async_wait_all();
  }
  __syncthreads();

  // 2. 512-point complex FFT of the packed, windowed frame. Thread tid takes
  // butterfly j of frames tid / 64 + 4 p. Frames past the clip's end (a
  // ragged last tile) are transformed too, from samples never loaded, and
  // never written out.
  const int j = tid % kBfly;
  int fr[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) fr[p] = tid / kBfly + (kThreads / kBfly) * p;
  {
    // pass 1 (Ns = 1, no twiddles) reads the span and writes the buffer
    const float2* win2 = reinterpret_cast<const float2*>(win);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float2* x2 = reinterpret_cast<const float2*>(xs + fr[p] * hop);
      float2 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = j + kBfly * r;
        const float2 x = x2[n], w = __ldg(&win2[n]);
        v[r] = make_float2(x.x * w.x, x.y * w.y);
      }
      fft8(v);
      float2* dst = buf + fr[p] * kStride;
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[pad(out_index<1>(j) + r)] = v[r];
    }
    __syncthreads();
  }
  pass_in_place<8, kPer>(buf, fr, j, ptw);
  pass_in_place<64, kPer>(buf, fr, j, ptw);

  // 3. split into the 513 bins of the real FFT; power over the buffer.
  // Thread tid takes the pair (k, 512 - k) of frames tid / 256 + i;
  // k = 0 gives bins 0 and 512, and bin 256 is |Z[256]|^2.
  constexpr int kSplitPer = kTile * (kN / 2) / kThreads;  // 8
  constexpr int kSplitStep = kThreads / (kN / 2);
  const int k = tid % (kN / 2);
  const int fs = tid / (kN / 2);
  const float2 wk = __ldg(&tw[k]);
  const float2 wn = make_float2(-wk.x, wk.y);  // W^(512 - k) = -conj(W^k)
  float pa[kSplitPer], pb[kSplitPer], pc[kSplitPer];
#pragma unroll
  for (int i = 0; i < kSplitPer; ++i) {
    const float2* Z = buf + (fs + kSplitStep * i) * kStride;
    const float2 zk = Z[pad(k)], zn = Z[pad((kN - k) & (kN - 1))];
    const float2 s = cadd(zk, cconj(zn)), d = csub(zk, cconj(zn));
    const float2 wd = cmul(wk, d);  // X[k] = s / 2 - i wd / 2
    const float2 xa = make_float2(0.5f * (s.x + wd.y), 0.5f * (s.y - wd.x));
    const float2 s2 = cconj(s), d2 = make_float2(-d.x, d.y);  // zn +- conj(zk)
    const float2 wd2 = cmul(wn, d2);
    const float2 xb = make_float2(0.5f * (s2.x + wd2.y),
                                  0.5f * (s2.y - wd2.x));
    pa[i] = xa.x * xa.x + xa.y * xa.y;
    pb[i] = xb.x * xb.x + xb.y * xb.y;
    pc[i] = 0.f;
    if (k == 0) {
      const float2 zm = Z[pad(kN / 2)];
      pc[i] = zm.x * zm.x + zm.y * zm.y;
    }
  }
  __syncthreads();  // every Z read before the power overwrites it
  // [kTile][2 kStride] floats, bins 0..512 used
  float* pw = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int i = 0; i < kSplitPer; ++i) {
    float* P = pw + (fs + kSplitStep * i) * 2 * kStride;
    P[k] = pa[i];
    P[kN - k] = pb[i];
    if (k == 0) P[kN / 2] = pc[i];
  }
  __syncthreads();

  // 4. banded filterbank. Bands widen from 2 bins (low mels) to 24 (high),
  // so thread tid takes a low and a high mel, r = tid % 128 and 127 - r,
  // each for two of its four frames tid / 128 + 2 i: the work of a
  // thread is about even, and each weight it loads serves two frames. A
  // warp writes 32 neighbouring mels of one frame's contiguous 512-byte row.
  const int r = tid % kMels;
  float* row = out + ((long long)clip * frames_per_clip + f0) * kMels;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = h == 0 ? r : kMels - 1 - r;
    const int4 band = __ldg(&bands[m]);  // start, length, offset
    const float* wts = band_w + band.z;
    const int fa = tid / kMels + (kThreads / kMels) * 2 * h;
    const int fb = fa + kThreads / kMels;
    const float* Pa = pw + fa * 2 * kStride + band.x;
    const float* Pb = pw + fb * 2 * kStride + band.x;
    float acc_a = 0.f, acc_b = 0.f;
    for (int q = 0; q < band.y; ++q) {
      const float w = __ldg(&wts[q]);
      acc_a = fmaf(Pa[q], w, acc_a);
      acc_b = fmaf(Pb[q], w, acc_b);
    }
    if (fa < nvalid) row[fa * kMels + m] = acc_a;
    if (fb < nvalid) row[fb * kMels + m] = acc_b;
  }
}

}  // namespace

// wave: (n_clips, clip_stride) fp32, reflect-padded clips, 16-byte aligned,
// clip_stride a multiple of 4, frames_per_clip frames of 1024 at hop (a
// multiple of 4, 4..1024) in each row; win (1024,) the periodic Hann window;
// tw (256, 2) exp(-2 pi i k / 1024); ptw (2, 7, 64, 2) the twiddles of the
// second and third radix-8 passes, [p, r - 1, j] =
// exp(-2 pi i (j % Ns) r / (8 Ns)) for Ns = 8, 64; bands (128, 4) int32
// start, length and offset of each mel's band (and a pad); band_w the packed
// band weights; out (n_clips * frames_per_clip, 128) fp32.
extern "C" int eg_mel(const void* wave, long long clip_stride, int n_clips,
                      int frames_per_clip, int hop, const void* win,
                      const void* tw, const void* ptw, const void* bands,
                      const void* band_w, void* out, void* stream) {
  if (hop < 4 || hop > kNFFT || hop % 4 || clip_stride % 4 || n_clips < 1 ||
      frames_per_clip < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)n_clips * ((frames_per_clip + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((kTile - 1) * hop + kNFFT) +
                      sizeof(float2) * kTile * kStride;
  cudaError_t err = cudaFuncSetAttribute(
      mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mel_fft_kernel<<<(unsigned)blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), clip_stride, frames_per_clip, hop,
      static_cast<const float*>(win), static_cast<const float2*>(tw),
      static_cast<const float2*>(ptw), static_cast<const int4*>(bands),
      static_cast<const float*>(band_w), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
