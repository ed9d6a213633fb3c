// One fast Griffin-Lim iteration for Hopper (sm_90a), fp32 throughout.
//
// Replaces audioflow_tpu/ops/pallas/griffinlim.py::griffin_lim_pallas (the
// Pallas kernel `_kernel`): from the rebuilt spectra r (this iteration's) and
// r2 (the previous one's) and the target magnitude, it computes
//   a = (1 + m)·r − m·r2,  s = mag · a / max(|a|, 1e-16)
// (momentum extrapolation and magnitude replacement), the windowed inverse
// real DFT of s, its overlap-add into hop-rows times the WOLA row inverse,
// and the windowed real DFT of every frame of that raw row stream: frame f
// reads rows [f, f + n_fft/hop), with no padding (the Pallas kernel's edge
// convention). ops/kernels/griffinlim.py designs the banks and the row
// inverse on the host and runs the iterations.
//
// Layout: r_re, r_im, r2_re, r2_im, mag, o_re, o_im [batch, n_frames, n_bins];
// cosb, sinb [n_fft, n_bins] the window-folded analysis banks; ciw, siw
// [n_bins, n_fft] the inverse banks with the synthesis window folded into
// their columns; inv [n_rows, hop] with n_rows = n_frames + n_fft/hop - 1;
// sig [batch, n_rows, hop] is scratch the wrapper allocates.
//
// The Pallas kernel walks a sequential grid over time tiles, carries the
// overlap-add tail in scratch and re-analyses one tile late, so that the
// signal never leaves VMEM. CUDA blocks run in no order, so one iteration is
// two passes whose blocks are independent:
//   (a) synthesis: a block owns 16 hop-rows of one signal; it computes the
//       prologue (momentum, magnitude replacement) of the frames that touch
//       them while staging their spectra in shared memory, sums the
//       overlap-add in a fixed order (dft.cuh), scales by inv and writes the
//       raw row stream to sig. Where the staged frames of all n_fft/hop
//       segments would not fit in shared memory (small hops), the segments
//       are taken in groups, restaged per group, in the same order;
//   (b) analysis: a block stages 16 frames of sig and its threads own bins
//       (dft.cuh), as in melspec.cu; it writes o_re/o_im.
//
// What bounds it: the function moves 7 state planes (5 in, 2 out) of
// [batch, n_frames, n_bins] fp32, 575 MB at [64, 626, 513], and needs about
// 2.5 GFLOP counted with FFTs, so it is bytes-bound (0.17 ms on an H100 at
// 3.35 TB/s). This kernel computes both DFTs as dense products instead
// (168 GFLOP at that shape) and is bound by its FMA rate; the row stream's round
// trip through device memory (41 MB each way) costs little beside that.
// Tensor cores (a 3xTF32 wgmma split), an FFT and fusing the passes are
// later work.

#include <cuda_runtime.h>

#include "dft.cuh"

namespace {

using dft::kFrames;
using dft::kRows;
using dft::kThreads;

// shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
constexpr int kMaxSmem = 232448;

int bins_padded(int n_fft) { return (n_fft / 2 + 1 + 3) & ~3; }

// Segments per synthesis group: all n_fft/hop when the staged spectra of
// their kRows + group - 1 frames fit in shared memory, else as many as fit
// (below 1: the transform does not fit at all).
int segment_group(int n_fft, int hop) {
  const int k = n_fft / hop;
  const int fit = kMaxSmem / (2 * bins_padded(n_fft) * static_cast<int>(sizeof(float))) - kRows + 1;
  return k < fit ? k : fit;
}

size_t analysis_smem(int n_fft) {
  return static_cast<size_t>(kFrames) * ((n_fft + 3) & ~3) * sizeof(float);
}

size_t synthesis_smem(int n_fft, int hop) {
  return static_cast<size_t>(2) * (kRows + segment_group(n_fft, hop) - 1) * bins_padded(n_fft) *
         sizeof(float);
}

// ------------------------------------------------------------- (a) synthesis

__global__ void __launch_bounds__(kThreads) synthesis_kernel(
    const float* __restrict__ r_re, const float* __restrict__ r_im,
    const float* __restrict__ r2_re, const float* __restrict__ r2_im,
    const float* __restrict__ mag, const float* __restrict__ ciw,
    const float* __restrict__ siw, const float* __restrict__ inv, float* __restrict__ sig,
    float c1, float m, int n_frames, int n_fft, int hop, int n_bins, int n_rows, int row_blocks,
    int group) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the spectra reads
  const int n_seg = n_fft / hop;
  const int kpad = (n_bins + 3) & ~3;
  float* sre = reinterpret_cast<float*>(smem4);  // [kRows + group - 1][kpad]
  float* sim = sre + (kRows + group - 1) * kpad;
  const int b = blockIdx.x / row_blocks;
  const int q0 = (blockIdx.x - b * row_blocks) * kRows;  // first hop-row
  const size_t plane = static_cast<size_t>(b) * n_frames * n_bins;
  const bool restage = group < n_seg;

  for (int n0 = 0; n0 < hop; n0 += kThreads) {
    const int n = n0 + threadIdx.x;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < n_seg; j0 += group) {
      const int j1 = min(j0 + group, n_seg);
      if (n0 == 0 || restage) {
        // slot s holds frame v0 + s; zeros outside [0, n_frames) and in the
        // bin padding
        const int count = kRows + j1 - j0 - 1, v0 = q0 - (j1 - 1);
        __syncthreads();  // every thread is done with the previous group
        for (int idx = threadIdx.x; idx < count * kpad; idx += kThreads) {
          const int s = idx / kpad, k = idx - s * kpad, v = v0 + s;
          float xr = 0.f, xi = 0.f;
          if (k < n_bins && v >= 0 && v < n_frames) {
            const size_t o = plane + static_cast<size_t>(v) * n_bins + k;
            const float ar = c1 * r_re[o] - m * r2_re[o];
            const float ai = c1 * r_im[o] - m * r2_im[o];
            const float guard = fmaxf(sqrtf(ar * ar + ai * ai), 1e-16f);
            const float g = mag[o];
            xr = g * (ar / guard);
            xi = g * (ai / guard);
          }
          sre[idx] = xr;
          sim[idx] = xi;
        }
        __syncthreads();
      }
      if (n < hop) dft::synthesise(sre, sim, kpad, ciw, siw, n, hop, n_fft, n_bins, j0, j1, acc);
    }
    if (n < hop) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int q = q0 + r;
        if (q < n_rows)
          sig[(static_cast<size_t>(b) * n_rows + q) * hop + n] = acc[r] * inv[static_cast<size_t>(q) * hop + n];
      }
    }
  }
}

// -------------------------------------------------------------- (b) analysis

__global__ void __launch_bounds__(kThreads, 2) analysis_kernel(
    const float* __restrict__ sig, const float* __restrict__ cosb,
    const float* __restrict__ sinb, float* __restrict__ o_re, float* __restrict__ o_im,
    long long total, int n_frames, int n_rows, int n_fft, int hop, int n_bins) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the frame reads
  float* frames = reinterpret_cast<float*>(smem4);
  const int ld = (n_fft + 3) & ~3;
  const long long g0 = static_cast<long long>(blockIdx.x) * kFrames;

  // stage the block's frames: frame f of signal b is sig[b] from row f on,
  // n_fft contiguous samples; frames past the end are zeros, never written out
  for (int f = 0; f < kFrames; ++f) {
    const long long g = g0 + f;
    float* dst = frames + f * ld;
    if (g < total) {
      const long long b = g / n_frames;
      const float* src = sig + (b * n_rows + (g - b * n_frames)) * hop;
      for (int n = threadIdx.x; n < ld; n += kThreads) dst[n] = n < n_fft ? src[n] : 0.f;
    } else {
      for (int n = threadIdx.x; n < ld; n += kThreads) dst[n] = 0.f;
    }
  }
  __syncthreads();
  dft::analyse(frames, ld, cosb, sinb, n_bins, n_fft, g0, total, o_re, o_im);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the larger of the two blocks; the wrapper checks
// it against its own mirror and the card's limit.
long long griffinlim_smem_bytes(int n_fft, int hop) {
  const size_t a = analysis_smem(n_fft), c = synthesis_smem(n_fft, hop);
  return static_cast<long long>(a > c ? a : c);
}

// One iteration: launches the two passes on `stream` and returns the first
// launch error (0 on success). Does not synchronise and allocates nothing.
// Needs hop | n_fft with n_fft / hop >= 2 and griffinlim_smem_bytes within
// the card's limit; c1 = 1 + m in fp32. The outputs must not alias r_re or
// r_im; they may alias r2_re and r2_im, which pass (a) has read in full
// before pass (b) writes.
int griffinlim_iter_launch(const float* r_re, const float* r_im, const float* r2_re,
                           const float* r2_im, const float* mag, const float* cosb,
                           const float* sinb, const float* ciw, const float* siw,
                           const float* inv, float* sig, float* o_re, float* o_im, int batch,
                           int n_frames, int n_fft, int hop, float c1, float m, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bins = n_fft / 2 + 1;
  const int n_rows = n_frames + n_fft / hop - 1;

  const size_t smem_a = synthesis_smem(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + kRows - 1) / kRows;
  synthesis_kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * row_blocks), kThreads,
                     smem_a, st>>>(r_re, r_im, r2_re, r2_im, mag, ciw, siw, inv, sig, c1, m,
                                   n_frames, n_fft, hop, n_bins, n_rows, row_blocks,
                                   segment_group(n_fft, hop));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_b = analysis_smem(n_fft);
  err = cudaFuncSetAttribute(
      analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long frames = static_cast<long long>(batch) * n_frames;
  analysis_kernel<<<static_cast<unsigned>((frames + kFrames - 1) / kFrames), kThreads, smem_b, st>>>(
      sig, cosb, sinb, o_re, o_im, frames, n_frames, n_rows, n_fft, hop, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
