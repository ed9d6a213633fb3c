// Fused log-mel spectrogram for Hopper (sm_90a), fp32 throughout.
//
// Replaces audioflow_tpu/ops/pallas/melspec.py::mel_spectrogram_pallas (the
// Pallas kernel `_kernel`): out = log(max(fb^T . (re^2 + im^2), floor)) over
// center=False frames, with re/im the windowed real DFT of each frame. The
// frames and the power spectrum stay in shared memory; only the signal, the
// designs and the mel output touch device memory.
//
// What it reads and writes: each row is a virtual signal [carry | chunk] of
// t = c + n samples, read in place from two segments, each by its own
// pointer and row stride (any stride, odd ones too: every sample is a 4-byte
// load), so that a stream step needs no concatenation. Frame g = row *
// n_frames + f starts at sample f * hop of its row (any hop); a frame that
// straddles the segments takes each sample from the one that holds it. The
// kernel also writes the new carry, the last c samples of each row, into a
// fresh [rows, c] tensor, by every thread of the grid after its frames. An
// offline call is the same launch with c = 0: one segment, no carry.
//
// Designs (MelspecParams, built once per design set and device by the
// wrapper): window [n_fft] is the analysis window and tw [n_fft/2] float2
// the FFT twiddles (fft.cuh); cosb, sinb [n_fft, n_bins] are the
// window-folded DFT banks of the dense path. The filterbank comes as bands:
// bands [3, n_mels] int32 holds each mel column's first nonzero bin, its
// count of bins up to its last nonzero one (0 for an empty column), and the
// offset of its weights in wts, packed contiguously. Only exact zeros
// outside each column's first-to-last range are skipped, so any filterbank
// works: the slaney bank at [513, 128] has 1,009 weights of 65,664. out
// [rows, n_frames, n_mels] is written as [rows * n_frames, n_mels].
//
// What bounds it: at the benchmark's step shape (2048 rows x 20 frames of
// 768 carried + 5120 new samples, n_fft 1024, 513 bins, 128 mels) the
// function reads 48.2 MB of signal and writes 21.0 MB of mel and 6.3 MB of
// carry, against about 1.25 GFLOP counted with an FFT and the bands, so
// bytes bound it (0.023 ms on an H100). Two paths behind one C entry,
// chosen by shape (melspec_path):
//
// FFT path (power-of-two n_fft from 16 to 2048): a block of kThreads
// threads owns kFftFrames = 8 consecutive frames of the flattened
// (row, frame) index, one per warp. A warp loads its frame straight from the
// segments (every load of a lane issued before its first shared-memory
// store; only a frame that starts in the carry picks a segment a sample),
// windows it, runs the forward real FFT in shared memory (fft.cuh) and
// writes the power spectrum over its slot; then threads over (frame, mel)
// sum the bands and apply the floor and the log. Shared memory at n_fft
// 1024: the twiddles 4 KB and 8 frame slots 34 KB. The kernel is compiled
// twice, with and without a carry, so that an offline call keeps the
// registers, and the five blocks an SM, of a kernel with one segment.
//
// Dense path (any other n_fft, such as 400 or 502): a block stages kFrames
// frames, its threads own kBinsPerThread bins for all of them (every bank
// value read from L2 feeds kFrames FMAs), the power rows go to shared memory,
// and threads over (mel, half of the frames) project them onto the bands.

#include <cuda_runtime.h>

#include "fft.cuh"

// A design set's launch parameters on a device, built once by the wrapper
// (ops/kernels/melspec.py mirrors this layout); outside the unnamed
// namespace, so that melspec_launch keeps C linkage. The FFT path reads the
// window and tw (the banks may be null), the dense path the banks (the
// window and tw may be null); both read the bands.
struct MelspecParams {
  const float* window;  // [n_fft]
  const float2* tw;     // [n_fft / 2]
  const float* cosb;    // [n_fft, n_bins]
  const float* sinb;    // [n_fft, n_bins]
  const int* bands;     // [3, n_mels]
  const float* wts;     // the bands' weights, packed
  int n_fft, hop, n_bins, n_mels, log_mode;
  float floor_;
};

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;
constexpr int kBinsPerThread = 2;
constexpr int kMelGroups = 2;  // frames split in the dense path's mel stage
constexpr int kFramesPerGroup = kFrames / kMelGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kFftFrames = 8;  // frames of an FFT-path block, one per warp

enum LogMode { kNone = 0, kLn = 1, kLog10 = 2, kDb = 3 };

struct Args {
  MelspecParams p;
  const float* carry;  // [rows] at carry_row apart, c samples each
  const float* chunk;  // [rows] at chunk_row apart, t - c samples each
  float* out;          // [rows * n_frames, n_mels], contiguous
  float* new_carry;    // [rows, c], contiguous
  long long carry_row, chunk_row, total;  // total = rows * n_frames
  int rows, c, t, n_frames;
};

// One frame's samples: sample k lies at lo + k where k < lim (in the carry),
// else at hi + k (in the chunk). A frame with lim <= 0 lies wholly in the
// chunk, as every frame of an offline call does; at<false> reads it with
// no compare.
struct Frame {
  const float* lo;
  const float* hi;
  int lim;

  template <bool kSplit = true>
  __device__ __forceinline__ float at(int k) const { return __ldg((kSplit && k < lim ? lo : hi) + k); }
};

__device__ __forceinline__ Frame frame_of(const Args& a, long long g) {
  const long long row = g / a.n_frames;
  const int p0 = static_cast<int>(g - row * a.n_frames) * a.p.hop;
  return {a.carry + row * a.carry_row + p0, a.chunk + row * a.chunk_row + (p0 - a.c), a.c - p0};
}

// The new carry, the last c samples of each row, written by every thread of
// the grid.
__device__ __forceinline__ void write_carry(const Args& a) {
  const long long n = static_cast<long long>(a.rows) * a.c;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long row = i / a.c;
    const int p = a.t - a.c + static_cast<int>(i - row * a.c);
    a.new_carry[i] = p < a.c ? __ldg(a.carry + row * a.carry_row + p) : __ldg(a.chunk + row * a.chunk_row + (p - a.c));
  }
}

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

// Complex points a lane packs of a frame of 2M samples.
__host__ __device__ constexpr int per_lane(int m) { return m >= 32 ? m / 32 : 1; }

// A lane's samples of its frame, in pairs: xr[i] = x[2j], x[2j+1] for
// j = lane + 32 i (the last pair again past M).
template <bool kSplit, int M>
__device__ __forceinline__ void load_frame(float (&xr)[per_lane(M)][2], const Frame& src, int lane) {
  constexpr int PER_LANE = per_lane(M);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int j = min(lane + 32 * i, M - 1);
    xr[i][0] = src.at<kSplit>(2 * j);
    xr[i][1] = src.at<kSplit>(2 * j + 1);
  }
}

// kCarry: the rows begin with a carry (c > 0). Without one the kernel is
// compiled with no two-segment load and no carry write: 48 registers at
// n_fft 1024, five blocks an SM, where the carry's form takes 64 and four.
template <int LOG_M, bool kCarry>
__global__ void __launch_bounds__(kThreads) melspec_fft_kernel(const Args a) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, SF = fft::slot_floats(M);
  constexpr int PAIRS = (HALF + 1 + 31) / 32;  // bin pairs per lane
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the twiddles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_mels = a.p.n_mels;
  float2* tw = reinterpret_cast<float2*>(smem4);
  float* buf = reinterpret_cast<float*>(tw + M);  // kFftFrames slots
  const long long g0 = static_cast<long long>(blockIdx.x) * kFftFrames;

  fft::load_twiddles(tw, a.p.tw, M);
  __syncthreads();
  for (int s = warp; s < kFftFrames; s += kWarps) {
    const long long g = g0 + s;
    if (g >= a.total) break;  // frames past the end are never written out
    float* zre = buf + s * SF;
    float* zim = zre + fft::padded(M);
    // the windowed frame, packed: z[j] = x[2j]·w[2j] + i·x[2j+1]·w[2j+1]
    // (every load of the lane issued before the first shared-memory store)
    const Frame src = frame_of(a, g);
    constexpr int PER_LANE = per_lane(M);
    float xr[PER_LANE][2];
    if (kCarry && src.lim > 0) {  // the frame starts in the carry: the same for the whole warp
      load_frame<true, M>(xr, src, lane);
    } else {
      load_frame<false, M>(xr, src, lane);
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < M) {
        zre[fft::padded(j)] = xr[i][0] * __ldg(a.p.window + 2 * j);
        zim[fft::padded(j)] = xr[i][1] * __ldg(a.p.window + 2 * j + 1);
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
    if (g >= a.total) continue;
    const float* pw = buf + s * SF + __ldg(a.p.bands + mel);
    const float* w = a.p.wts + __ldg(a.p.bands + 2 * n_mels + mel);
    const int count = __ldg(a.p.bands + n_mels + mel);
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(pw[i], __ldg(w + i), acc);
    a.out[g * n_mels + mel] = finish(acc, a.p.floor_, a.p.log_mode);
  }
  if (kCarry) write_carry(a);
}

template <int LOG_M, bool kCarry>
cudaError_t launch_fft(const Args& a, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      melspec_fft_kernel<LOG_M, kCarry>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  melspec_fft_kernel<LOG_M, kCarry><<<static_cast<unsigned>((a.total + kFftFrames - 1) / kFftFrames), kThreads, smem, st>>>(a);
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

__global__ void __launch_bounds__(kThreads, 2) melspec_dense_kernel(const Args a) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the frame reads
  const int n_fft = a.p.n_fft, n_bins = a.p.n_bins, n_mels = a.p.n_mels;
  float* frames = reinterpret_cast<float*>(smem4);
  const int ld = (n_fft + 3) & ~3;  // frame row stride, a multiple of 4 floats
  float* pw = frames + kFrames * ld;
  const long long g0 = static_cast<long long>(blockIdx.x) * kFrames;

  // stage the block's frames; frames past the end are zeros and never written out
  for (int f = 0; f < kFrames; ++f) {
    const long long g = g0 + f;
    float* dst = frames + f * ld;
    if (g < a.total) {
      const Frame src = frame_of(a, g);
      for (int n = threadIdx.x; n < ld; n += kThreads) dst[n] = n < n_fft ? src.at(n) : 0.f;
    } else {
      for (int n = threadIdx.x; n < ld; n += kThreads) dst[n] = 0.f;
    }
  }
  __syncthreads();

  int k0 = 0;
  for (; k0 + kBinsPerThread * kThreads <= n_bins; k0 += kBinsPerThread * kThreads)
    dft_pass<kBinsPerThread>(frames, ld, pw, a.p.cosb, a.p.sinb, k0, n_bins, n_fft);
  for (; k0 < n_bins; k0 += kThreads)
    dft_pass<1>(frames, ld, pw, a.p.cosb, a.p.sinb, k0, n_bins, n_fft);
  __syncthreads();

  for (int item = threadIdx.x; item < n_mels * kMelGroups; item += kThreads) {
    const int mel = item % n_mels;
    const int f0 = (item / n_mels) * kFramesPerGroup;
    const int lo = __ldg(a.p.bands + mel), count = __ldg(a.p.bands + n_mels + mel);
    const float* w = a.p.wts + __ldg(a.p.bands + 2 * n_mels + mel);
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
      if (g < a.total) a.out[g * n_mels + mel] = finish(acc[f], a.p.floor_, a.p.log_mode);
    }
  }
  write_carry(a);
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

// sizeof(MelspecParams), for the wrapper's check of its mirror.
int melspec_params_bytes() { return static_cast<int>(sizeof(MelspecParams)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. Each of `rows` rows is c samples of
// `carry` (carry_row apart) then n samples of `chunk` (chunk_row apart);
// with c = 0 the carry is never read and new_carry may be null. Writes
// out [rows, n_frames, n_mels] and new_carry [rows, c], both contiguous;
// the wrapper has checked that c + n >= n_fft and that c + n and rows are
// below 2**31.
int melspec_launch(const MelspecParams* params, const float* carry, long long carry_row, int c,
                   const float* chunk, long long chunk_row, int n, float* out, float* new_carry, int rows,
                   void* stream) {
  const MelspecParams& p = *params;
  const int t = c + n, n_frames = (t - p.n_fft) / p.hop + 1;
  const Args a{p, carry, chunk, out, new_carry, carry_row, chunk_row,
               static_cast<long long>(rows) * n_frames, rows, c, t, n_frames};
  if (a.total <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fft_frames(p.n_fft) > 0) {
    const size_t smem = fft_smem(p.n_fft);
    cudaError_t err = cudaErrorInvalidValue;
    switch (half_log(p.n_fft)) {
#define AF_CASE(L)                                                                            \
  case L:                                                                                     \
    err = a.c > 0 ? launch_fft<L, true>(a, smem, st) : launch_fft<L, false>(a, smem, st);  \
    break;
      AF_CASE(3) AF_CASE(4) AF_CASE(5) AF_CASE(6) AF_CASE(7) AF_CASE(8) AF_CASE(9) AF_CASE(10)
#undef AF_CASE
    }
    return static_cast<int>(err);
  }
  const size_t smem = dense_smem(p.n_fft, p.n_bins);
  cudaError_t err = cudaFuncSetAttribute(
      melspec_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  melspec_dense_kernel<<<static_cast<unsigned>((a.total + kFrames - 1) / kFrames), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
