// Fused log-mel spectrogram for Hopper (sm_90a), fp32 throughout.
//
// Replaces audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas (the
// Pallas kernel `_kernel`): out = log(max(fb^T . (re^2 + im^2), floor)) over
// center=False frames, with re/im the windowed real DFT of each frame. The
// frames and the power spectrum stay in shared memory; only the signal, the
// designs and the mel output touch device memory.
//
// Layout: x [batch, t] row-major; frame g = row * n_frames + f starts at
// x[row, f * hop] (any hop). window [n_fft] is the analysis window and tw
// [n_fft/2] float2 the FFT twiddles (fft.cuh); cosb, sinb [n_fft, n_bins]
// are the window-folded DFT banks of the dense path. The filterbank comes as
// bands: bands [3, n_mels] int32 holds each mel column's first nonzero bin,
// its count of bins up to its last nonzero one (0 for an empty column), and
// the offset of its weights in wts, packed contiguously. Only exact zeros
// outside each column's first-to-last range are skipped, so any filterbank
// works: the slaney bank at [513, 128] has 1,009 weights of 65,664. out
// [batch, n_frames, n_mels] is written as [batch * n_frames, n_mels].
//
// What bounds it: at the main path's step shape (512 rows x 20 frames, n_fft
// 1024, 513 bins, 128 mels) the function reads 12 MB of signal and writes
// 5 MB of mel, against about 0.31 GFLOP counted with an FFT and the bands,
// so bytes bound it (0.005 ms on an H100). Two paths behind one C entry,
// chosen by shape (melspec_path):
//
// FFT path (power-of-two n_fft from 16 to 2048): a block of kThreads
// threads owns kFftFrames = 8 consecutive frames of the flattened
// (row, frame) index, one per warp. A warp loads its frame straight from x
// (every load of a lane issued before its first shared-memory store),
// windows it, runs the forward real FFT in shared memory (fft.cuh) and
// writes the power spectrum over its slot; then threads over (frame, mel)
// sum the bands and apply the floor and the log. Shared memory at n_fft
// 1024: the twiddles 4 KB and 8 frame slots 34 KB; 5 blocks per SM.
//
// Dense path (any other n_fft, such as 400 or 502): a block stages kFrames
// frames, its threads own kBinsPerThread bins for all of them (every bank
// value read from L2 feeds kFrames FMAs), the power rows go to shared memory,
// and threads over (mel, half of the frames) project them onto the bands.

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;
constexpr int kBinsPerThread = 2;
constexpr int kMelGroups = 2;  // frames split in the dense path's mel stage
constexpr int kFramesPerGroup = kFrames / kMelGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kFftFrames = 8;  // frames of an FFT-path block, one per warp

enum LogMode { kNone = 0, kLn = 1, kLog10 = 2, kDb = 3 };

// log2(n_fft / 2) for a power of two n_fft from 16 to 2048, else -1
int half_log(int n_fft) {
  if ((n_fft & (n_fft - 1)) != 0) return -1;
  int l = 0;
  while ((2 << l) < n_fft) ++l;
  return l >= fft::kMinLogM && l <= fft::kMaxLogM ? l : -1;
}

size_t fft_smem(int n_fft) {
  const int m = n_fft / 2;
  return static_cast<size_t>(m) * sizeof(float2) +
         static_cast<size_t>(kFftFrames) * fft::slot_floats(m) * sizeof(float);
}

// Frames per FFT-path block, or 0 where n_fft takes the dense path.
int fft_frames(int n_fft) { return half_log(n_fft) < 0 ? 0 : kFftFrames; }

size_t dense_smem(int n_fft, int n_bins) {
  return static_cast<size_t>(kFrames) * (((n_fft + 3) & ~3) + n_bins) * sizeof(float);
}

__device__ __forceinline__ float finish(float v, float floor_, int log_mode) {
  v = v < floor_ ? floor_ : v;  // max(v, floor) that keeps a NaN, as jnp.maximum does
  switch (log_mode) {
    case kLn: return logf(v);
    case kLog10: return log10f(v);
    case kDb: return 10.f * log10f(v);
    default: return v;
  }
}

// ------------------------------------------------------------------ FFT path

template <int LOG_M>
__global__ void __launch_bounds__(kThreads) melspec_fft_kernel(
    const float* __restrict__ x, const float* __restrict__ window, const float2* __restrict__ tw_g,
    const int* __restrict__ bands, const float* __restrict__ wts, float* __restrict__ out,
    long long total, int t, int hop, int n_mels, int n_frames, int log_mode, float floor_) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, SF = fft::slot_floats(M);
  constexpr int PAIRS = (HALF + 1 + 31) / 32;  // bin pairs per lane
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the twiddles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* tw = reinterpret_cast<float2*>(smem4);
  float* buf = reinterpret_cast<float*>(tw + M);  // kFftFrames slots
  const long long g0 = static_cast<long long>(blockIdx.x) * kFftFrames;

  fft::load_twiddles(tw, tw_g, M);
  __syncthreads();
  for (int s = warp; s < kFftFrames; s += kWarps) {
    const long long g = g0 + s;
    if (g >= total) break;  // frames past the end are never written out
    float* zre = buf + s * SF;
    float* zim = zre + fft::padded(M);
    // the windowed frame, packed: z[j] = x[2j]·w[2j] + i·x[2j+1]·w[2j+1]
    // (every load of the lane issued before the first shared-memory store)
    const long long row = g / n_frames;
    const float* src = x + row * t + (g - row * n_frames) * hop;
    constexpr int PER_LANE = M >= 32 ? M / 32 : 1;
    float xr[PER_LANE][2];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = min(lane + 32 * i, M - 1);
      xr[i][0] = __ldg(src + 2 * j);
      xr[i][1] = __ldg(src + 2 * j + 1);
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < M) {
        zre[fft::padded(j)] = xr[i][0] * __ldg(window + 2 * j);
        zim[fft::padded(j)] = xr[i][1] * __ldg(window + 2 * j + 1);
      }
    }
    fft::warp_fft<LOG_M, false>(zre, zim, tw, lane);
    // the power spectrum of bins 0..M, written over the slot once read
    float pk[PAIRS], pc[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int k = lane + 32 * i;
      if (k <= HALF) {
        float2 xk, xc;
        fft::real_forward(zre, zim, k, M, tw, xk, xc);
        pk[i] = xk.x * xk.x + xk.y * xk.y;
        pc[i] = xc.x * xc.x + xc.y * xc.y;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int k = lane + 32 * i;
      if (k <= HALF) {
        zre[k] = pk[i];
        if (k < HALF) zre[M - k] = pc[i];
      }
    }
  }
  __syncthreads();

  for (int it = threadIdx.x; it < kFftFrames * n_mels; it += kThreads) {
    const int s = it / n_mels, mel = it - s * n_mels;
    const long long g = g0 + s;
    if (g >= total) continue;
    const float* pw = buf + s * SF + __ldg(bands + mel);
    const float* w = wts + __ldg(bands + 2 * n_mels + mel);
    const int count = __ldg(bands + n_mels + mel);
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(pw[i], __ldg(w + i), acc);
    out[g * n_mels + mel] = finish(acc, floor_, log_mode);
  }
}

template <int LOG_M>
cudaError_t launch_fft(const float* x, const float* window, const float* tw, const int* bands,
                       const float* wts, float* out, long long total, int t, int hop, int n_mels,
                       int n_frames, int log_mode, float floor_, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      melspec_fft_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  melspec_fft_kernel<LOG_M><<<static_cast<unsigned>((total + kFftFrames - 1) / kFftFrames), kThreads, smem,
                              st>>>(x, window, reinterpret_cast<const float2*>(tw), bands, wts, out, total, t,
                                    hop, n_mels, n_frames, log_mode, floor_);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dense path

// re/im of bins k0 + threadIdx.x + b * kThreads (b < BPT) for every frame of
// the block, then their power into pw [kFrames, n_bins]. A thread whose last
// bin is out of range returns: in a full pass none is, in the one-bin
// leftover pass those past n_bins are. No barrier inside.
template <int BPT>
__device__ __forceinline__ void dft_pass(
    const float* __restrict__ frames, int ld, float* __restrict__ pw,
    const float* __restrict__ cosb, const float* __restrict__ sinb,
    int k0, int n_bins, int n_fft) {
  int k[BPT];
#pragma unroll
  for (int b = 0; b < BPT; ++b) k[b] = k0 + threadIdx.x + b * kThreads;
  if (k[BPT - 1] >= n_bins) return;

  float re[BPT][kFrames], im[BPT][kFrames];
#pragma unroll
  for (int b = 0; b < BPT; ++b)
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[b][f] = im[b][f] = 0.f;

  const int n4 = n_fft & ~3;
  for (int n = 0; n < n4; n += 4) {
    float c[4][BPT], s[4][BPT];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < BPT; ++b) {
        const size_t o = static_cast<size_t>(n + j) * n_bins + k[b];
        c[j][b] = __ldg(cosb + o);
        s[j][b] = __ldg(sinb + o);
      }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float4 v = *reinterpret_cast<const float4*>(frames + f * ld + n);
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < BPT; ++b) {
          re[b][f] = fmaf(xv[j], c[j][b], re[b][f]);
          im[b][f] = fmaf(xv[j], s[j][b], im[b][f]);
        }
    }
  }
  for (int n = n4; n < n_fft; ++n) {  // n_fft % 4 tail
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      const size_t o = static_cast<size_t>(n) * n_bins + k[b];
      const float c = __ldg(cosb + o), s = __ldg(sinb + o);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        re[b][f] = fmaf(frames[f * ld + n], c, re[b][f]);
        im[b][f] = fmaf(frames[f * ld + n], s, im[b][f]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < BPT; ++b)
#pragma unroll
    for (int f = 0; f < kFrames; ++f)
      pw[f * n_bins + k[b]] = re[b][f] * re[b][f] + im[b][f] * im[b][f];
}

__global__ void __launch_bounds__(kThreads, 2) melspec_dense_kernel(
    const float* __restrict__ x, const float* __restrict__ cosb,
    const float* __restrict__ sinb, const int* __restrict__ bands, const float* __restrict__ wts,
    float* __restrict__ out, long long total, int t, int n_fft, int hop,
    int n_bins, int n_mels, int n_frames, int log_mode, float floor_) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the frame reads
  float* frames = reinterpret_cast<float*>(smem4);
  const int ld = (n_fft + 3) & ~3;  // frame row stride, a multiple of 4 floats
  float* pw = frames + kFrames * ld;
  const long long g0 = static_cast<long long>(blockIdx.x) * kFrames;

  // stage the block's frames; frames past the end are zeros and never written out
  for (int f = 0; f < kFrames; ++f) {
    const long long g = g0 + f;
    float* dst = frames + f * ld;
    const float* src = nullptr;
    if (g < total) {
      const long long row = g / n_frames;
      src = x + row * t + (g - row * n_frames) * hop;
    }
    for (int n = threadIdx.x; n < ld; n += kThreads)
      dst[n] = (src != nullptr && n < n_fft) ? src[n] : 0.f;
  }
  __syncthreads();

  int k0 = 0;
  for (; k0 + kBinsPerThread * kThreads <= n_bins; k0 += kBinsPerThread * kThreads)
    dft_pass<kBinsPerThread>(frames, ld, pw, cosb, sinb, k0, n_bins, n_fft);
  for (; k0 < n_bins; k0 += kThreads)
    dft_pass<1>(frames, ld, pw, cosb, sinb, k0, n_bins, n_fft);
  __syncthreads();

  for (int item = threadIdx.x; item < n_mels * kMelGroups; item += kThreads) {
    const int mel = item % n_mels;
    const int f0 = (item / n_mels) * kFramesPerGroup;
    const int lo = __ldg(bands + mel), count = __ldg(bands + n_mels + mel);
    const float* w = wts + __ldg(bands + 2 * n_mels + mel);
    float acc[kFramesPerGroup];
#pragma unroll
    for (int f = 0; f < kFramesPerGroup; ++f) acc[f] = 0.f;
    for (int i = 0; i < count; ++i) {
      const float wi = __ldg(w + i);
#pragma unroll
      for (int f = 0; f < kFramesPerGroup; ++f)
        acc[f] = fmaf(pw[(f0 + f) * n_bins + lo + i], wi, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < kFramesPerGroup; ++f) {
      const long long g = g0 + f0 + f;
      if (g < total) out[g * n_mels + mel] = finish(acc[f], floor_, log_mode);
    }
  }
}

}  // namespace

extern "C" {

// Frames per block of the FFT path, or 0 where n_fft takes the dense path.
int melspec_path(int n_fft) { return fft_frames(n_fft); }

// Dynamic shared memory one block of the path needs; the wrapper checks it
// against its own mirror and the card's limit.
long long melspec_smem_bytes(int n_fft, int n_bins) {
  const int frames = fft_frames(n_fft);
  return static_cast<long long>(frames > 0 ? fft_smem(n_fft) : dense_smem(n_fft, n_bins));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. The FFT path reads window and tw
// (the banks may be null); the dense path reads the banks (window and tw may
// be null). Both read the bands.
int melspec_launch(const float* x, const float* window, const float* tw, const float* cosb,
                   const float* sinb, const int* bands, const float* wts, float* out, int batch,
                   int t, int n_fft, int hop, int n_bins, int n_mels, int n_frames, int log_mode,
                   float floor_, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(batch) * n_frames;
  const int frames = fft_frames(n_fft);
  const size_t smem = frames > 0 ? fft_smem(n_fft) : dense_smem(n_fft, n_bins);
  if (frames > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    switch (half_log(n_fft)) {
#define AF_CASE(L)                                                                                  \
  case L:                                                                                           \
    err = launch_fft<L>(x, window, tw, bands, wts, out, total, t, hop, n_mels, n_frames, log_mode,  \
                        floor_, smem, st);                                                          \
    break;
      AF_CASE(3) AF_CASE(4) AF_CASE(5) AF_CASE(6) AF_CASE(7) AF_CASE(8) AF_CASE(9) AF_CASE(10)
#undef AF_CASE
    }
    return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(
      melspec_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  melspec_dense_kernel<<<static_cast<unsigned>((total + kFrames - 1) / kFrames), kThreads, smem, st>>>(
      x, cosb, sinb, bands, wts, out, total, t, n_fft, hop, n_bins, n_mels, n_frames, log_mode,
      floor_);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
