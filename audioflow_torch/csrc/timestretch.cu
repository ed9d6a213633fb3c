// Fused phase-vocoder time stretch for Hopper (sm_90a), fp32 throughout.
//
// Replaces audioflow_tpu/ops/pallas/timestretch.py::time_stretch_pallas (the
// Pallas kernel `_kernel`): STFT -> phasor phase vocoder at a rational rate
// p/q -> inverse STFT with overlap-add and the window-square normalisation.
// ops/kernels/timestretch.py states the function step by step; the wrapper
// designs the banks and the normaliser on the host. The dense DFT loops of
// passes (a) and (c) are in dft.cuh, shared with griffinlim.cu.
//
// Layout: x [batch, t] row-major. cosb, sinb [n_fft, n_bins] are the
// window-folded analysis banks, ciw, siw [n_bins, n_fft] the inverse-DFT
// banks with the synthesis window folded into their columns, norm [out_len]
// the clamped window-square overlap-add over the trimmed output. re, im
// [batch, n_in, n_bins] and s_re, s_im [batch, n_out, n_bins] are scratch the
// wrapper allocates; out is [batch, out_len].
//
// The Pallas kernel walks a sequential grid over time tiles and carries the
// phase and the overlap-add tail from one tile to the next in scratch; CUDA
// blocks run in no order, so this design splits the work in three passes
// whose blocks are independent:
//   (a) analysis: a block stages 16 consecutive frames of the flattened
//       (row, frame) index in shared memory (reflect padding done on the
//       fly) and threads own bins, as in melspec.cu; it writes re/im;
//   (b) phase: one thread per (row, bin), bins on neighbouring threads,
//       walks the output frames in order: the integer lo = v*p/q replaces
//       the TPU's masked-roll selection, and the loop replaces its
//       Hillis-Steele scan. The carry is renormalised every step. Each
//       thread refills its own 32-frame column of shared memory with
//       independent loads, so there is no barrier and many loads in flight;
//   (c) synthesis: a block owns 16 consecutive output hop-rows of one row.
//       Row r is the sum over j < n_fft/hop of segment j of frame r - j, so
//       the block stages the spectra of those 16 + k - 1 frames and each
//       thread owns one output column; each (frame, segment) pair is
//       computed by exactly one block, in a fixed order, without atomics:
//       the result is the same from run to run. It divides by norm and
//       writes only the trimmed output.
//
// What bounds it: arithmetic. At the pvoc shape (64 rows x 160,000 samples,
// rate 5/4, n_fft 1024, hop 256) the forward DFT of 628 frames and the
// inverse of 502 are 4 * 1024 * 513 FLOP per frame per row, 152 GFLOP,
// against 74 MB of signal in and out. Each bank value read from L2 feeds 16
// frames (analysis) or 16 rows (synthesis); the spectra read in (c) are
// float4 shared-memory broadcasts. The intermediates (about 0.6 GB of device
// traffic) cost little beside that; fusing them, and tensor cores (a 3xTF32
// wgmma split), are later work.

#include <cuda_runtime.h>

#include "dft.cuh"

namespace {

using dft::kFrames;
using dft::kRows;
using dft::kThreads;
constexpr int kPhaseThreads = 128; // (b) threads per block
constexpr int kChunk = 32;         // (b) input frames each thread stages

// ---------------------------------------------------------------- (a) analysis

// Sample i of x reflect-padded by `half` on both sides, zero past the padding.
__device__ __forceinline__ float padded(const float* __restrict__ row, int i, int t, int half) {
  int j = i - half;
  if (j < 0) return row[-j];
  if (j < t) return row[j];
  if (j < t + half) return row[2 * (t - 1) - j];
  return 0.f;
}

__global__ void __launch_bounds__(kThreads, 2) analysis_kernel(
    const float* __restrict__ x, const float* __restrict__ cosb,
    const float* __restrict__ sinb, float* __restrict__ re, float* __restrict__ im,
    long long total, int t, int n_fft, int hop, int n_bins, int n_in) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the frame reads
  float* frames = reinterpret_cast<float*>(smem4);
  const int ld = (n_fft + 3) & ~3;
  const int half = n_fft / 2;
  const long long g0 = static_cast<long long>(blockIdx.x) * kFrames;

  // stage the block's frames; frames past the end are zeros and never written out
  for (int f = 0; f < kFrames; ++f) {
    const long long g = g0 + f;
    float* dst = frames + f * ld;
    if (g < total) {
      const long long row = g / n_in;
      const float* src = x + row * t;
      const int base = static_cast<int>(g - row * n_in) * hop;
      for (int n = threadIdx.x; n < ld; n += kThreads)
        dst[n] = n < n_fft ? padded(src, base + n, t, half) : 0.f;
    } else {
      for (int n = threadIdx.x; n < ld; n += kThreads) dst[n] = 0.f;
    }
  }
  __syncthreads();
  dft::analyse(frames, ld, cosb, sinb, n_bins, n_fft, g0, total, re, im);
}

// ------------------------------------------------------------------- (b) phase

// The unit increment phasor from frame a to frame b, 1 where |a||b| is 0.
__device__ __forceinline__ void increment(float ar, float ai, float am, float br, float bi,
                                          float bm, float& ur, float& ui) {
  const float d = bm * am;
  if (d > 0.f) {
    ur = (br * ar + bi * ai) / d;
    ui = (bi * ar - br * ai) / d;
  } else {
    ur = 1.f;
    ui = 0.f;
  }
}

// (zr, zi) / m, or the unit phasor 1 where m is 0.
__device__ __forceinline__ void unit(float& zr, float& zi, float m) {
  if (m > 0.f) {
    zr = zr / m;
    zi = zi / m;
  } else {
    zr = 1.f;
    zi = 0.f;
  }
}

// Frame f of this thread's (row, bin) lane, with its magnitude. Frames are
// asked for in non-decreasing order; a miss restages the thread's own
// column of shared memory from frame f on, with kChunk independent loads.
// Only this thread touches its column, so no barrier is needed.
__device__ __forceinline__ void fetch(float (*cre)[kPhaseThreads], float (*cim)[kPhaseThreads],
                                      int& c0, const float* __restrict__ rr,
                                      const float* __restrict__ ri, int n_bins, int n_in, int f,
                                      float& fr, float& fi, float& fm) {
  const int tid = threadIdx.x;
  if (f >= c0 + kChunk) {
    c0 = f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (f + j < n_in) {
        cre[j][tid] = rr[static_cast<size_t>(f + j) * n_bins];
        cim[j][tid] = ri[static_cast<size_t>(f + j) * n_bins];
      }
    }
  }
  fr = cre[f - c0][tid];
  fi = cim[f - c0][tid];
  fm = sqrtf(fr * fr + fi * fi);
}

__global__ void __launch_bounds__(kPhaseThreads) phase_kernel(
    const float* __restrict__ re, const float* __restrict__ im, float* __restrict__ s_re,
    float* __restrict__ s_im, long long total, int n_bins, int n_in, int n_out, int p, int q) {
  __shared__ float cre[kChunk][kPhaseThreads], cim[kChunk][kPhaseThreads];
  const long long g = static_cast<long long>(blockIdx.x) * kPhaseThreads + threadIdx.x;
  if (g >= total) return;
  const long long row = g / n_bins;
  const int k = static_cast<int>(g - row * n_bins);
  const float* rr = re + row * n_in * n_bins + k;  // frame f at rr[f * n_bins]
  const float* ri = im + row * n_in * n_bins + k;
  float* sr = s_re + row * n_out * n_bins + k;
  float* si = s_im + row * n_out * n_bins + k;
  int c0 = -kChunk;

  int lo = 0;
  float ar, ai, am, br, bi, bm, ur, ui;
  fetch(cre, cim, c0, rr, ri, n_bins, n_in, 0, ar, ai, am);
  fetch(cre, cim, c0, rr, ri, n_bins, n_in, 1, br, bi, bm);
  increment(ar, ai, am, br, bi, bm, ur, ui);
  float zr = ar, zi = ai;
  unit(zr, zi, am);

  const float inv_q = 1.f / static_cast<float>(q);
  for (int v = 0; v < n_out; ++v) {
    const long long vp = static_cast<long long>(v) * p;
    const int want = static_cast<int>(vp / q);
    const float frac = static_cast<float>(vp - static_cast<long long>(want) * q) * inv_q;
    if (want != lo) {
      if (want == lo + 1) {
        ar = br, ai = bi, am = bm;
      } else {
        fetch(cre, cim, c0, rr, ri, n_bins, n_in, want, ar, ai, am);
      }
      fetch(cre, cim, c0, rr, ri, n_bins, n_in, want + 1, br, bi, bm);
      increment(ar, ai, am, br, bi, bm, ur, ui);
      lo = want;
    }
    const float mag = (1.f - frac) * am + frac * bm;
    sr[static_cast<size_t>(v) * n_bins] = mag * zr;
    si[static_cast<size_t>(v) * n_bins] = mag * zi;
    float nr = zr * ur - zi * ui, ni = zr * ui + zi * ur;
    unit(nr, ni, sqrtf(nr * nr + ni * ni));
    zr = nr, zi = ni;
  }
}

// --------------------------------------------------------------- (c) synthesis

__global__ void __launch_bounds__(kThreads) synthesis_kernel(
    const float* __restrict__ s_re, const float* __restrict__ s_im,
    const float* __restrict__ ciw, const float* __restrict__ siw,
    const float* __restrict__ norm, float* __restrict__ out, int n_fft, int hop,
    int n_bins, int n_out, int out_len, int row_first, int row_blocks) {
  extern __shared__ float4 smem4[];
  const int n_seg = n_fft / hop;
  const int kpad = (n_bins + 3) & ~3;
  const int n_stage = kRows + n_seg - 1;
  float* sre = reinterpret_cast<float*>(smem4);  // [n_stage][kpad]
  float* sim = sre + n_stage * kpad;
  const int b = blockIdx.x / row_blocks;
  const int r0 = row_first + (blockIdx.x - b * row_blocks) * kRows;  // first hop-row
  const int v0 = r0 - (n_seg - 1);  // frame in staged slot 0

  // stage the spectra of frames v0 .. v0 + n_stage - 1; zeros outside [0, n_out)
  // and in the bin padding
  for (int idx = threadIdx.x; idx < n_stage * kpad; idx += kThreads) {
    const int f = idx / kpad, k = idx - f * kpad, v = v0 + f;
    const bool ok = k < n_bins && v >= 0 && v < n_out;
    const size_t o = (static_cast<size_t>(b) * n_out + v) * n_bins + k;
    sre[idx] = ok ? s_re[o] : 0.f;
    sim[idx] = ok ? s_im[o] : 0.f;
  }
  __syncthreads();

  const int half = n_fft / 2;
  for (int n = threadIdx.x; n < hop; n += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    dft::synthesise(sre, sim, kpad, ciw, siw, n, hop, n_fft, n_bins, 0, n_seg, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long j = static_cast<long long>(r0 + r) * hop + n - half;  // trimmed index
      if (r0 + r < n_out && j >= 0 && j < out_len)
        out[static_cast<size_t>(b) * out_len + j] = acc[r] / norm[j];
    }
  }
}

size_t analysis_smem(int n_fft) {
  return static_cast<size_t>(kFrames) * ((n_fft + 3) & ~3) * sizeof(float);
}

size_t synthesis_smem(int n_fft, int hop) {
  const int kpad = (n_fft / 2 + 1 + 3) & ~3;
  return static_cast<size_t>(2) * (kRows + n_fft / hop - 1) * kpad * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the larger of the two blocks that take it; the
// wrapper checks it against its own mirror and the card's limit.
long long timestretch_smem_bytes(int n_fft, int hop) {
  const size_t a = analysis_smem(n_fft), c = synthesis_smem(n_fft, hop);
  return static_cast<long long>(a > c ? a : c);
}

// Launches the three passes on `stream` and returns the first launch error
// (0 on success). Does not synchronise and allocates nothing. Needs hop |
// n_fft and t > n_fft / 2; n_in = (n_out - 1) * p / q + 2 and n_out =
// ceil((n_fft / 2 + out_len) / hop).
int timestretch_launch(const float* x, const float* cosb, const float* sinb,
                       const float* ciw, const float* siw, const float* norm,
                       float* re, float* im, float* s_re, float* s_im, float* out,
                       int batch, int t, int n_fft, int hop, int p, int q, int n_in,
                       int n_out, int out_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bins = n_fft / 2 + 1;

  const size_t smem_a = analysis_smem(n_fft);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long frames = static_cast<long long>(batch) * n_in;
  analysis_kernel<<<static_cast<unsigned>((frames + kFrames - 1) / kFrames), kThreads, smem_a, st>>>(
      x, cosb, sinb, re, im, frames, t, n_fft, hop, n_bins, n_in);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long lanes = static_cast<long long>(batch) * n_bins;
  phase_kernel<<<static_cast<unsigned>((lanes + kPhaseThreads - 1) / kPhaseThreads),
                 kPhaseThreads, 0, st>>>(re, im, s_re, s_im, lanes, n_bins, n_in, n_out, p, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_c = synthesis_smem(n_fft, hop);
  err = cudaFuncSetAttribute(
      synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_first = (n_fft / 2) / hop;
  const int row_blocks = (n_out - row_first + kRows - 1) / kRows;
  synthesis_kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * row_blocks), kThreads,
                     smem_c, st>>>(s_re, s_im, ciw, siw, norm, out, n_fft, hop, n_bins, n_out,
                                   out_len, row_first, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
