// Dense real-DFT device code shared by timestretch.cu and griffinlim.cu, fp32
// FMA (no tensor cores).
//
// Analysis: a block stages kFrames frames in shared memory and its threads
// own bins; each bank value read (from L2) feeds kFrames frames.
// Synthesis: a block owns kRows consecutive hop-rows of one signal. Hop-row
// r is the sum over segments j of segment j of frame r - j, so the block
// stages the spectra of the frames that touch its rows and each thread owns
// one output column: every (frame, segment) pair is computed by exactly one
// block, in a fixed order, without atomics, so the result is the same from
// run to run.

#pragma once

#include <cuda_runtime.h>

namespace dft {

constexpr int kThreads = 256;      // threads of an analysis or synthesis block
constexpr int kFrames = 16;        // frames an analysis block stages
constexpr int kBinsPerThread = 2;  // bins per thread in a full analysis pass
constexpr int kRows = 16;          // hop-rows a synthesis block owns

// re/im of bins k0 + threadIdx.x + b * kThreads (b < BPT) for every staged
// frame. A thread whose last bin is out of range returns. No barrier inside.
template <int BPT>
__device__ __forceinline__ void dft_pass(
    const float* __restrict__ frames, int ld, const float* __restrict__ cosb,
    const float* __restrict__ sinb, int k0, int n_bins, int n_fft, long long g0,
    long long total, float* __restrict__ re_out, float* __restrict__ im_out) {
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
  for (int f = 0; f < kFrames; ++f) {
    const long long g = g0 + f;
    if (g >= total) break;
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      re_out[g * n_bins + k[b]] = re[b][f];
      im_out[g * n_bins + k[b]] = im[b][f];
    }
  }
}

// Windowed DFT of the kFrames frames staged at `frames` (row stride ld, a
// multiple of 4, zero past n_fft), written to rows g0.. (below total) of
// re_out/im_out [total, n_bins]: two-bin passes, then one-bin passes.
__device__ __forceinline__ void analyse(
    const float* __restrict__ frames, int ld, const float* __restrict__ cosb,
    const float* __restrict__ sinb, int n_bins, int n_fft, long long g0, long long total,
    float* __restrict__ re_out, float* __restrict__ im_out) {
  int k0 = 0;
  for (; k0 + kBinsPerThread * kThreads <= n_bins; k0 += kBinsPerThread * kThreads)
    dft_pass<kBinsPerThread>(frames, ld, cosb, sinb, k0, n_bins, n_fft, g0, total, re_out, im_out);
  for (; k0 < n_bins; k0 += kThreads)
    dft_pass<1>(frames, ld, cosb, sinb, k0, n_bins, n_fft, g0, total, re_out, im_out);
}

// acc[r] += segment j of the inverse DFT of staged slot r - j + j1 - 1, for
// the segments j in [j0, j1), at output column n. sre/sim hold the staged
// spectra [slot][kpad] (kpad = n_bins rounded up to 4, zero past n_bins);
// ciw/siw [n_bins, n_fft] are the inverse banks with the synthesis window
// folded into their columns.
__device__ __forceinline__ void synthesise(
    const float* __restrict__ sre, const float* __restrict__ sim, int kpad,
    const float* __restrict__ ciw, const float* __restrict__ siw, int n, int hop, int n_fft,
    int n_bins, int j0, int j1, float (&acc)[kRows]) {
  for (int j = j0; j < j1; ++j) {
    const float* cb = ciw + j * hop + n;  // bank row k at cb[k * n_fft]
    const float* sb = siw + j * hop + n;
    for (int k = 0; k < kpad; k += 4) {
      float c[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // past n_bins the staged spectra are zero; any finite bank value does
        const size_t o = static_cast<size_t>(min(k + i, n_bins - 1)) * n_fft;
        c[i] = __ldg(cb + o);
        s[i] = __ldg(sb + o);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int f = r - j + j1 - 1;
        const float4 a = *reinterpret_cast<const float4*>(sre + f * kpad + k);
        const float4 e = *reinterpret_cast<const float4*>(sim + f * kpad + k);
        float v = acc[r];
        v = fmaf(a.x, c[0], v);
        v = fmaf(a.y, c[1], v);
        v = fmaf(a.z, c[2], v);
        v = fmaf(a.w, c[3], v);
        v = fmaf(e.x, s[0], v);
        v = fmaf(e.y, s[1], v);
        v = fmaf(e.z, s[2], v);
        v = fmaf(e.w, s[3], v);
        acc[r] = v;
      }
    }
  }
}

}  // namespace dft
