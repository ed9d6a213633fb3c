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
// convention). ops/kernels/griffinlim.py designs the window, the twiddles,
// the banks and the row inverse on the host and runs the iterations.
//
// Layout: r_re, r_im, r2_re, r2_im, mag, o_re, o_im [batch, n_frames, n_bins];
// window [n_fft] the analysis and synthesis window; tw [n_fft/2] float2 the
// FFT twiddles (fft.cuh); cosb, sinb [n_fft, n_bins] the window-folded
// analysis banks; ciw, siw [n_bins, n_fft] the inverse banks with the
// synthesis window folded into their columns; inv [n_rows, hop] with
// n_rows = n_frames + n_fft/hop - 1; sig [batch, n_rows, hop] is scratch of
// the dense path.
//
// What bounds it: the function moves 7 state planes (5 in, 2 out) of
// [batch, n_frames, n_bins] fp32, 575 MB at [64, 626, 513], and needs about
// 2.5 GFLOP counted with FFTs, so it is bytes-bound (0.17 ms on an H100 at
// 3.35 TB/s). Two paths behind one C entry, chosen by shape
// (griffinlim_path):
//
// FFT path (power-of-two n_fft from 16 to 2048 with k = n_fft/hop <=
// kMaxFftK): one pass per iteration, the signal never in device memory. A
// block of kThreads threads (8 warps) owns T = kFftTile consecutive output
// frames of one signal. It computes the prologue of frames
// [f0-k+1, f0+T+k-1) (the halo recomputed: 2(k-1)/T more reads of the 5
// input planes) straight from device memory into the inverse FFT's
// pre-twiddle, one frame per warp (fft.cuh), and overlap-adds the windowed
// frames into its T+k-1 hop-rows in shared memory: after each batch of 8
// frames, threads own row samples and add the batch's frames in ascending
// order, so each sum is taken in one fixed order, without atomics, the same
// from run to run. Then it scales the rows by inv, and forward-transforms its
// T frames, one per warp, writing o_re/o_im. A lane issues the 10 loads of
// kLoadGroup bin pairs before its first shared-memory store, so that a
// frame costs a few memory round trips, not one per pair.
// Shared memory at n_fft 1024, hop 256: the twiddles 4 KB, 8 frame slots
// 34 KB, the rows 19 KB; with 64 registers, 4 blocks (32 warps) per SM.
// T = 16 reads 37% more of the input planes than the frames need (9% at
// T = 64), but more blocks per SM hide each other's memory waits better
// than a smaller halo saves: on the H100 the smaller tile is the faster.
//
// Dense path (every other configuration supported() takes: n_fft not a power
// of two, or k above kMaxFftK): two passes whose blocks are independent:
//   (a) synthesis: a block owns 16 hop-rows of one signal; it computes the
//       prologue of the frames that touch them while staging their spectra
//       in shared memory, sums the overlap-add in a fixed order (dft.cuh),
//       scales by inv and writes the raw row stream to sig. Where the staged
//       frames of all n_fft/hop segments would not fit in shared memory
//       (small hops), the segments are taken in groups, restaged per group,
//       in the same order;
//   (b) analysis: a block stages 16 frames of sig and its threads own bins
//       (dft.cuh); it writes o_re/o_im.
// It computes both DFTs as dense FMA products, 68x the FFT-counted work at
// the main path's shape.

#include <cuda_runtime.h>

#include "dft.cuh"
#include "fft.cuh"

namespace {

using dft::kFrames;
using dft::kRows;
using dft::kThreads;

// shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
constexpr int kMaxSmem = 232448;
// the largest n_fft/hop the FFT path takes: the halo recompute grows with k
constexpr int kMaxFftK = 16;
constexpr int kWarps = kThreads / 32;  // an FFT-path block transforms kWarps frames at once
constexpr int kFftTile = 16;            // output frames of an FFT-path block
constexpr int kLoadGroup = 3;           // bin pairs whose 10 loads a lane issues at once

int bins_padded(int n_fft) { return (n_fft / 2 + 1 + 3) & ~3; }

// log2(n_fft / 2) for a power of two n_fft from 16 to 2048, else -1
int half_log(int n_fft) {
  if ((n_fft & (n_fft - 1)) != 0) return -1;
  int l = 0;
  while ((2 << l) < n_fft) ++l;
  return l >= fft::kMinLogM && l <= fft::kMaxLogM ? l : -1;
}

size_t fft_smem(int n_fft, int hop, int tile) {
  const int m = n_fft / 2;
  return static_cast<size_t>(m) * sizeof(float2) +
         (static_cast<size_t>(kWarps) * fft::slot_floats(m) +
          static_cast<size_t>(tile + n_fft / hop - 1) * hop) * sizeof(float);
}

// The FFT path's tile T, or 0 where the configuration takes the dense path.
int fft_tile(int n_fft, int hop) {
  if (half_log(n_fft) < 0 || n_fft / hop > kMaxFftK || fft_smem(n_fft, hop, kFftTile) > kMaxSmem) return 0;
  return kFftTile;
}

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

// ------------------------------------------------------------------ FFT path

// s = mag · a / max(|a|, 1e-16) with a = c1·r − m·r2, from v = (r_re,
// r_im, r2_re, r2_im, mag) at one bin
__device__ __forceinline__ float2 prologue(const float (&v)[5], float c1, float m) {
  const float ar = c1 * v[0] - m * v[2];
  const float ai = c1 * v[1] - m * v[3];
  const float guard = fmaxf(sqrtf(ar * ar + ai * ai), 1e-16f);
  return make_float2(v[4] * (ar / guard), v[4] * (ai / guard));
}

template <int LOG_M>
__global__ void __launch_bounds__(kThreads) fft_kernel(
    const float* __restrict__ r_re, const float* __restrict__ r_im,
    const float* __restrict__ r2_re, const float* __restrict__ r2_im,
    const float* __restrict__ mag, const float* __restrict__ window,
    const float2* __restrict__ tw_g, const float* __restrict__ inv, float* __restrict__ o_re,
    float* __restrict__ o_im, float c1, float mom, int n_frames, int hop, int tile, int tiles) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, N_BINS = M + 1, N_FFT = 2 * M;
  constexpr int HP = fft::padded(M), SF = fft::slot_floats(M);
  constexpr int PAIRS = (HALF + 1 + 31) / 32;  // bin pairs per lane
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the twiddles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_seg = N_FFT / hop;
  float2* tw = reinterpret_cast<float2*>(smem4);
  float* buf = reinterpret_cast<float*>(tw + M);  // one frame slot per warp
  float* rows = buf + kWarps * SF;                // hop-rows [f0, f0 + tile + k - 1)
  float* zre = buf + warp * SF;
  float* zim = zre + HP;
  const int n_local = (tile + k_seg - 1) * hop;
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - b * tiles) * tile;
  const size_t plane = static_cast<size_t>(b) * n_frames * N_BINS;
  constexpr float kInvN = 1.f / N_FFT;  // a power of two: exact

  fft::load_twiddles(tw, tw_g, M);
  for (int i = threadIdx.x; i < n_local; i += kThreads) rows[i] = 0.f;
  __syncthreads();

  // synthesis: every frame that touches the block's rows, one per warp
  const int v_begin = max(f0 - k_seg + 1, 0), v_end = min(f0 + tile + k_seg - 1, n_frames);
  for (int vb = v_begin; vb < v_end; vb += kWarps) {
    const int v = vb + warp;
    if (v < v_end) {
      const size_t o = plane + static_cast<size_t>(v) * N_BINS;
      // bin pairs (k, M - k), kLoadGroup per lane at once: all their loads
      // are issued before the first shared-memory store
      for (int i0 = 0; i0 < PAIRS; i0 += kLoadGroup) {
        float in[kLoadGroup][2][5];
#pragma unroll
        for (int g = 0; g < kLoadGroup; ++g) {
          const int k = min(lane + 32 * (i0 + g), HALF);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t q = o + (e ? M - k : k);
            in[g][e][0] = __ldg(r_re + q);
            in[g][e][1] = __ldg(r_im + q);
            in[g][e][2] = __ldg(r2_re + q);
            in[g][e][3] = __ldg(r2_im + q);
            in[g][e][4] = __ldg(mag + q);
          }
        }
#pragma unroll
        for (int g = 0; g < kLoadGroup; ++g) {
          const int k = lane + 32 * (i0 + g);
          if (k > HALF) break;
          float2 xk = prologue(in[g][0], c1, mom), xm = prologue(in[g][1], c1, mom);
          if (k == 0) xk.y = xm.y = 0.f;  // the bank form ignores Im at DC and Nyquist
          float2 zk, zc;
          fft::real_inverse(xk, xm, k, tw, zk, zc);
          zre[fft::padded(k)] = zk.x;
          zim[fft::padded(k)] = zk.y;
          if (k > 0 && k < HALF) {
            zre[fft::padded(M - k)] = zc.x;
            zim[fft::padded(M - k)] = zc.y;
          }
        }
      }
      fft::warp_fft<LOG_M, true>(zre, zim, tw, lane);
    }
    __syncthreads();
    // overlap-add: sample n of frame v lands at (v - f0)·hop + n of the rows;
    // each row sample adds the batch's frames in ascending order
    const int nb = min(kWarps, v_end - vb);
    const int p_end = min((vb + nb - 1 - f0) * hop + N_FFT, n_local);
    for (int p = max((vb - f0) * hop, 0) + threadIdx.x; p < p_end; p += kThreads) {
      float acc = rows[p];
      for (int s = 0; s < nb; ++s) {
        const int n = p - (vb + s - f0) * hop;
        if (n >= 0 && n < N_FFT) {
          const float* z = buf + s * SF + (n & 1) * HP;
          acc = fmaf(z[fft::padded(n >> 1)] * kInvN, __ldg(window + n), acc);
        }
      }
      rows[p] = acc;
    }
    __syncthreads();
  }

  // the WOLA row inverse: local row sample i is row-stream sample f0·hop + i
  const int n_row_samples = (n_frames + k_seg - 1) * hop;
  for (int i = threadIdx.x; i < n_local; i += kThreads) {
    const int g = f0 * hop + i;
    if (g < n_row_samples) rows[i] *= __ldg(inv + g);
  }
  __syncthreads();

  // analysis: the block's frames, one per warp at a time
  const int f_end = min(f0 + tile, n_frames);
  for (int f = f0 + warp; f < f_end; f += kWarps) {
    const float* src = rows + (f - f0) * hop;
    for (int j = lane; j < M; j += 32) {
      zre[fft::padded(j)] = src[2 * j] * __ldg(window + 2 * j);
      zim[fft::padded(j)] = src[2 * j + 1] * __ldg(window + 2 * j + 1);
    }
    fft::warp_fft<LOG_M, false>(zre, zim, tw, lane);
    const size_t o = plane + static_cast<size_t>(f) * N_BINS;
    for (int k = lane; k <= HALF; k += 32) {
      float2 xk, xc;
      fft::real_forward(zre, zim, k, M, tw, xk, xc);
      o_re[o + k] = xk.x;
      o_im[o + k] = xk.y;
      if (k < HALF) {
        o_re[o + M - k] = xc.x;
        o_im[o + M - k] = xc.y;
      }
    }
    __syncwarp();  // the slot is read before the next frame overwrites it
  }
}

template <int LOG_M>
cudaError_t launch_fft(const float* r_re, const float* r_im, const float* r2_re, const float* r2_im,
                       const float* mag, const float* window, const float* tw, const float* inv,
                       float* o_re, float* o_im, int batch, int n_frames, int hop, int tile, float c1,
                       float m, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fft_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n_frames + tile - 1) / tile;
  fft_kernel<LOG_M><<<static_cast<unsigned>(static_cast<long long>(batch) * tiles), kThreads, smem, st>>>(
      r_re, r_im, r2_re, r2_im, mag, window, reinterpret_cast<const float2*>(tw), inv, o_re, o_im, c1, m,
      n_frames, hop, tile, tiles);
  return cudaGetLastError();
}

// ----------------------------------------------------- dense (a) synthesis

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
          float2 x = make_float2(0.f, 0.f);
          if (k < n_bins && v >= 0 && v < n_frames) {
            const size_t o = plane + static_cast<size_t>(v) * n_bins + k;
            const float in[5] = {r_re[o], r_im[o], r2_re[o], r2_im[o], mag[o]};
            x = prologue(in, c1, m);
          }
          sre[idx] = x.x;
          sim[idx] = x.y;
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

// ------------------------------------------------------ dense (b) analysis

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

cudaError_t launch_dense(const float* r_re, const float* r_im, const float* r2_re, const float* r2_im,
                         const float* mag, const float* cosb, const float* sinb, const float* ciw,
                         const float* siw, const float* inv, float* sig, float* o_re, float* o_im,
                         int batch, int n_frames, int n_fft, int hop, float c1, float m, cudaStream_t st) {
  const int n_bins = n_fft / 2 + 1;
  const int n_rows = n_frames + n_fft / hop - 1;
  const size_t smem_a = synthesis_smem(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return err;
  const int row_blocks = (n_rows + kRows - 1) / kRows;
  synthesis_kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * row_blocks), kThreads,
                     smem_a, st>>>(r_re, r_im, r2_re, r2_im, mag, ciw, siw, inv, sig, c1, m,
                                   n_frames, n_fft, hop, n_bins, n_rows, row_blocks,
                                   segment_group(n_fft, hop));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_b = analysis_smem(n_fft);
  err = cudaFuncSetAttribute(
      analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_b));
  if (err != cudaSuccess) return err;
  const long long frames = static_cast<long long>(batch) * n_frames;
  analysis_kernel<<<static_cast<unsigned>((frames + kFrames - 1) / kFrames), kThreads, smem_b, st>>>(
      sig, cosb, sinb, o_re, o_im, frames, n_frames, n_rows, n_fft, hop, n_bins);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The FFT path's tile T (output frames per block), or 0 for the dense path.
int griffinlim_path(int n_fft, int hop) { return fft_tile(n_fft, hop); }

// Dynamic shared memory of the path's largest block; the wrapper checks it
// against its own mirror and the card's limit.
long long griffinlim_smem_bytes(int n_fft, int hop) {
  const int tile = fft_tile(n_fft, hop);
  if (tile > 0) return static_cast<long long>(fft_smem(n_fft, hop, tile));
  const size_t a = analysis_smem(n_fft), c = synthesis_smem(n_fft, hop);
  return static_cast<long long>(a > c ? a : c);
}

// One iteration on `stream`; returns the first launch error (0 on success).
// Does not synchronise and allocates nothing. Needs hop | n_fft with
// n_fft / hop >= 2 and griffinlim_smem_bytes within the card's limit;
// c1 = 1 + m in fp32. The FFT path reads window and tw (and not the banks or
// sig, which may be null); the dense path reads the banks and writes sig
// (window and tw may be null). The outputs must alias no input: a block
// reads the input planes of its neighbours' frames.
int griffinlim_iter_launch(const float* r_re, const float* r_im, const float* r2_re,
                           const float* r2_im, const float* mag, const float* window,
                           const float* tw, const float* cosb, const float* sinb, const float* ciw,
                           const float* siw, const float* inv, float* sig, float* o_re, float* o_im,
                           int batch, int n_frames, int n_fft, int hop, float c1, float m, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = fft_tile(n_fft, hop);
  if (tile == 0)
    return static_cast<int>(launch_dense(r_re, r_im, r2_re, r2_im, mag, cosb, sinb, ciw, siw, inv, sig,
                                         o_re, o_im, batch, n_frames, n_fft, hop, c1, m, st));
  const size_t smem = fft_smem(n_fft, hop, tile);
  cudaError_t err = cudaErrorInvalidValue;
  switch (half_log(n_fft)) {
#define AF_CASE(L)                                                                                 \
  case L:                                                                                          \
    err = launch_fft<L>(r_re, r_im, r2_re, r2_im, mag, window, tw, inv, o_re, o_im, batch, n_frames, \
                        hop, tile, c1, m, smem, st);                                               \
    break;
    AF_CASE(3) AF_CASE(4) AF_CASE(5) AF_CASE(6) AF_CASE(7) AF_CASE(8) AF_CASE(9) AF_CASE(10)
#undef AF_CASE
  }
  return static_cast<int>(err);
}

}  // extern "C"
