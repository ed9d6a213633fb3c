// Fused log-mel spectrogram for Hopper (sm_90a), fp32 throughout.
//
// Replaces audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas (the
// Pallas kernel `_kernel`): out = log(max(fb^T . (re^2 + im^2), floor)) over
// center=False frames, with re/im the windowed real DFT of each frame. The
// [frames, n_fft] frame tensor and the [frames, n_bins] power spectrum stay
// in shared memory; only the signal, the banks and the mel output touch
// device memory.
//
// Layout: x [batch, t] row-major; frame g = row * n_frames + f starts at
// x[row, f * hop]. cosb, sinb [n_fft, n_bins] are the window-folded DFT banks
// and fb [n_bins, n_mels] the mel filterbank, all designed on the host, so
// every window and filterbank option works unchanged. out [batch, n_frames,
// n_mels] is written as [batch * n_frames, n_mels].
//
// What bounds it: arithmetic. At the main path's step shape (512 rows x 20
// frames, n_fft 1024, 513 bins) one call is 21.5 GFLOP of DFT plus 1.3 GFLOP
// of mel projection against 12 MB of signal in and 5 MB out. The design
// keeps the FMA units fed:
//   * one block owns kFrames consecutive frames of the flattened
//     (row, frame) index, so any frame count fills the grid (512 x 20 frames
//     are 640 blocks over 132 SMs) and no tile of a row is mostly padding;
//   * the block stages its frames in shared memory, read straight from the
//     signal at stride hop (no hop | n_fft requirement);
//   * each thread owns kBinsPerThread bins for all kFrames frames: every bank
//     value read from L2 feeds kFrames FMAs, and each float4 read of a frame
//     from shared memory (a broadcast: all lanes read one address) feeds
//     4 * 2 * kBinsPerThread FMAs;
//   * the leftover bins (513 = 2 * 256 + 1) run in a one-bin pass in which
//     threads without a bin return at once;
//   * then threads over (mel, half of the frames) project the power rows
//     from shared memory onto the filterbank and apply the floor and log.
// The bank reads are the next limit (each block streams both banks, 4.2 MB,
// from L2); tensor cores (wgmma with a 3xTF32 split) and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;
constexpr int kBinsPerThread = 2;
constexpr int kMelGroups = 2;  // frames split in the mel stage
constexpr int kFramesPerGroup = kFrames / kMelGroups;

enum LogMode { kNone = 0, kLn = 1, kLog10 = 2, kDb = 3 };

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

__device__ __forceinline__ float finish(float v, float floor_, int log_mode) {
  v = v < floor_ ? floor_ : v;  // max(v, floor) that keeps a NaN, as jnp.maximum does
  switch (log_mode) {
    case kLn: return logf(v);
    case kLog10: return log10f(v);
    case kDb: return 10.f * log10f(v);
    default: return v;
  }
}

__global__ void __launch_bounds__(kThreads, 2) melspec_kernel(
    const float* __restrict__ x, const float* __restrict__ cosb,
    const float* __restrict__ sinb, const float* __restrict__ fb,
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
    const int m = item % n_mels;
    const int f0 = (item / n_mels) * kFramesPerGroup;
    float acc[kFramesPerGroup];
#pragma unroll
    for (int f = 0; f < kFramesPerGroup; ++f) acc[f] = 0.f;
    for (int k = 0; k < n_bins; ++k) {
      const float w = __ldg(fb + static_cast<size_t>(k) * n_mels + m);
#pragma unroll
      for (int f = 0; f < kFramesPerGroup; ++f)
        acc[f] = fmaf(pw[(f0 + f) * n_bins + k], w, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < kFramesPerGroup; ++f) {
      const long long g = g0 + f0 + f;
      if (g < total) out[g * n_mels + m] = finish(acc[f], floor_, log_mode);
    }
  }
}

size_t smem_bytes(int n_fft, int n_bins) {
  return static_cast<size_t>(kFrames) * (((n_fft + 3) & ~3) + n_bins) * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it against the card.
long long melspec_smem_bytes(int n_fft, int n_bins) {
  return static_cast<long long>(smem_bytes(n_fft, n_bins));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing.
int melspec_launch(const float* x, const float* cosb, const float* sinb,
                   const float* fb, float* out, int batch, int t, int n_fft,
                   int hop, int n_bins, int n_mels, int n_frames, int log_mode,
                   float floor_, void* stream) {
  const size_t smem = smem_bytes(n_fft, n_bins);
  cudaError_t err = cudaFuncSetAttribute(
      melspec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * n_frames;
  const long long blocks = (total + kFrames - 1) / kFrames;
  melspec_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, cosb, sinb, fb, out, total, t, n_fft, hop, n_bins, n_mels, n_frames,
      log_mode, floor_);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
