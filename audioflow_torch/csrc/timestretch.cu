// Fused phase-vocoder time stretch for Hopper (sm_90a), fp32 but for the FFT
// path's analysis transform, which runs in fp64.
//
// Replaces audioflow_tpu/ops/pallas/timestretch.py::time_stretch_pallas (the
// Pallas kernel `_kernel`): STFT -> phasor phase vocoder at a rational rate
// p/q -> inverse STFT with overlap-add and the window-square normalisation.
// ops/kernels/timestretch.py states the function step by step; the wrapper
// designs the window, the twiddles, the banks and the normaliser on the host.
//
// Layout: x [batch, t] row-major; window [n_fft] the analysis and synthesis
// window; tw and tw64 [n_fft/2] the FFT twiddles (fft.cuh) as float2 and
// double2; cosb, sinb
// [n_fft, n_bins] the window-folded analysis banks, ciw, siw [n_bins, n_fft]
// the inverse-DFT banks with the synthesis window folded into their columns;
// norm [out_len] the clamped window-square overlap-add over the trimmed
// output. re, im [batch, n_in, n_bins] and s_re, s_im [batch, n_out, n_bins]
// are scratch the wrapper allocates; out is [batch, out_len].
//
// The Pallas kernel walks a sequential grid over time tiles and carries the
// phase and the overlap-add tail from one tile to the next in scratch; CUDA
// blocks run in no order, so the work is three passes whose blocks are
// independent: (a) analysis writes re/im, (b) phase writes s_re/s_im, (c)
// synthesis writes out. Two paths behind one C entry, chosen by shape
// (timestretch_path):
//
// FFT path (power-of-two n_fft from 16 to 2048, hop | n_fft):
//   (a) one warp per input frame (fft.cuh): a lane reads the frame's samples
//       with the reflect padding and the zero extension done on the fly,
//       times the window, even samples into the slot's real parts and odd
//       ones into its imaginary parts; the warp's FFT and the real split give
//       the bins, in fp64, each rounded to fp32 once. Step 5 accumulates the
//       phase of every increment u = s[f+1]·conj(s[f]) over hundreds of
//       frames, and an fp32 transform's rounding is relative to the frame's
//       energy, not to the bin's: at the weak bins beside a tone it turns the
//       phases, and the walk carries the turn to every later frame. Two fp32
//       forms of the DFT (this FFT and the plain version's bank products)
//       then differ by more than the 1e-4 tolerance at the pvoc shape
//       (PERF.md); rounding only the finished bins keeps the kernel within it;
//
//   (c) a block owns T = 16 consecutive output hop-rows of one signal (the
//       tile, timestretch_path) and inverse-transforms every output frame that
//       touches them, one per warp (the frames of the k - 1 rows before the
//       tile are recomputed by the block before it: (T + k - 1)/T transforms
//       per frame, k = n_fft/hop), overlap-adds them into the rows in shared
//       memory, each row sample adding a batch's frames in ascending frame
//       order (no atomics: two launches are bitwise equal), then divides by
//       norm and writes only the trimmed output.
// Dense path (every other configuration supported() takes): (a) and (c) are
// the dense DFT loops of dft.cuh against the banks, as in griffinlim.cu.
//
// (b) phase, both paths: the sequential phasor recurrence z_{v+1} =
// unit(z_v·u[lo(v)]) per (row, bin), given parallelism over time in the
// TPU kernel's tiled form (pallas/timestretch.py:209-227, 299-329). A block
// owns 32 consecutive bins of one row, one per lane, and kSegments warps own
// consecutive segments of the output frames. Each warp walks its segment
// from 1 and keeps the segment's product; one warp then carries the phase
// across the segments, renormalised at each boundary; then each warp walks
// its segment again from its carry, writing s = mag·z. Segment 0 is the
// sequential walk itself; the others differ from it by rounding only.
//
// What bounds it: at the pvoc shape (64 rows x 160,000 samples, rate 5/4,
// n_fft 1024, hop 256) the 628 forward and 502 inverse real FFTs a row are
// 2.55 GFLOP; the intermediates re/im (165 MB) and s_re/s_im (132 MB) are
// each written once and read about twice, and with the 41 MB of signal in
// and 33 MB out the passes move about 1 GB: memory, not arithmetic, bounds
// the FFT path (about 0.3 ms at 3.35 TB/s). It takes about 0.85 ms on an
// H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the phase pass 0.37 ms,
// each step of a walk a dependent load, the fp64 analysis 0.25 ms and the
// synthesis 0.22 ms. Fusing the passes would take the intermediates out of
// device memory; that is later work.

#include <cuda_runtime.h>

#include "dft.cuh"
#include "fft.cuh"

namespace {

using dft::kFrames;
using dft::kRows;
using dft::kThreads;

constexpr int kWarps = kThreads / 32;  // an FFT-path block transforms kWarps frames at once
constexpr int kFftTile = 16;           // output hop-rows of an FFT-path synthesis block (8 to 64 timed alike)
constexpr int kFramesPerWarp = 4;      // input frames each analysis warp transforms
constexpr int kLoadGroup = 4;          // bin pairs whose 4 loads a synthesis lane issues at once
constexpr int kSegments = 8;           // (b) time segments of a phase block, one per warp

// Sample i of x reflect-padded by `half` on both sides, zero past the padding.
__device__ __forceinline__ float sample(const float* __restrict__ row, int i, int t, int half) {
  int j = i - half;
  if (j < 0) return row[-j];
  if (j < t) return row[j];
  if (j < t + half) return row[2 * (t - 1) - j];
  return 0.f;
}

// log2(n_fft / 2) for a power of two n_fft from 16 to 2048, else -1
int half_log(int n_fft) {
  if (n_fft < 2 || (n_fft & (n_fft - 1)) != 0) return -1;
  int l = 0;
  while ((2 << l) < n_fft) ++l;
  return l >= fft::kMinLogM && l <= fft::kMaxLogM ? l : -1;
}

// the fp64 twiddles and frame slots, then the window
size_t fft_analysis_smem(int n_fft) {
  const int m = n_fft / 2;
  return static_cast<size_t>(m) * sizeof(double2) +
         static_cast<size_t>(kWarps) * fft::slot_floats(m) * sizeof(double) + static_cast<size_t>(n_fft) * sizeof(float);
}

// the fp32 twiddles, the window, the frame slots and the tile's hop-rows
size_t fft_synthesis_smem(int n_fft, int hop) {
  const int m = n_fft / 2;
  return static_cast<size_t>(m) * sizeof(float2) +
         (static_cast<size_t>(n_fft) + static_cast<size_t>(kWarps) * fft::slot_floats(m) +
          static_cast<size_t>(kFftTile) * hop) * sizeof(float);
}

// The FFT path's synthesis tile T, or 0 where the configuration takes the
// dense path. Every block of the path fits: at n_fft 2048 and hop 2048 the
// synthesis block takes 215,040 bytes.
int fft_tile(int n_fft, int hop) {
  return half_log(n_fft) >= 0 && hop >= 1 && n_fft % hop == 0 ? kFftTile : 0;
}

size_t dense_analysis_smem(int n_fft) {
  return static_cast<size_t>(kFrames) * ((n_fft + 3) & ~3) * sizeof(float);
}

size_t dense_synthesis_smem(int n_fft, int hop) {
  const int kpad = (n_fft / 2 + 1 + 3) & ~3;
  return static_cast<size_t>(2) * (kRows + n_fft / hop - 1) * kpad * sizeof(float);
}

// ------------------------------------------------------- FFT (a) analysis

template <int LOG_M>
__global__ void __launch_bounds__(kThreads) fft_analysis_kernel(
    const float* __restrict__ x, const float* __restrict__ window, const double2* __restrict__ tw_g,
    float* __restrict__ re, float* __restrict__ im, long long total, int t, int hop, int n_in) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, N_FFT = 2 * M, N_BINS = M + 1;
  constexpr int HP = fft::padded(M), SF = fft::slot_floats(M);
  extern __shared__ double2 smem2[];  // double2: 16-byte alignment for the twiddles and slots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double2* tw = smem2;
  double* zre = reinterpret_cast<double*>(tw + M) + warp * SF;  // one frame slot per warp
  double* zim = zre + HP;
  float* win = reinterpret_cast<float*>(reinterpret_cast<double*>(tw + M) + kWarps * SF);

  fft::load_twiddles(tw, tw_g, M);
  for (int i = threadIdx.x; i < N_FFT; i += kThreads) win[i] = window[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + warp; g < total; g += stride) {
    const long long row = g / n_in;
    const float* src = x + row * t;
    const int base = static_cast<int>(g - row * n_in) * hop;
    for (int j = lane; j < M; j += 32) {  // the products of two floats are exact in fp64
      zre[fft::padded(j)] = static_cast<double>(sample(src, base + 2 * j, t, M)) * win[2 * j];
      zim[fft::padded(j)] = static_cast<double>(sample(src, base + 2 * j + 1, t, M)) * win[2 * j + 1];
    }
    fft::warp_fft<LOG_M, false>(zre, zim, tw, lane);
    float* ro = re + g * N_BINS;
    float* io = im + g * N_BINS;
    for (int k = lane; k <= HALF; k += 32) {  // each bin rounded to fp32 once
      double2 xk, xc;
      fft::real_forward(zre, zim, k, M, tw, xk, xc);
      ro[k] = static_cast<float>(xk.x);
      io[k] = static_cast<float>(xk.y);
      if (k < HALF) {
        ro[M - k] = static_cast<float>(xc.x);
        io[M - k] = static_cast<float>(xc.y);
      }
    }
    __syncwarp();  // the slot is read before the next frame overwrites it
  }
}

// ----------------------------------------------------- FFT (c) synthesis

template <int LOG_M>
__global__ void __launch_bounds__(kThreads) fft_synthesis_kernel(
    const float* __restrict__ s_re, const float* __restrict__ s_im, const float* __restrict__ window,
    const float2* __restrict__ tw_g, const float* __restrict__ norm, float* __restrict__ out, int hop,
    int n_out, int out_len, int row_first, int row_blocks) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, N_FFT = 2 * M, N_BINS = M + 1;
  constexpr int HP = fft::padded(M), SF = fft::slot_floats(M);
  constexpr int PAIRS = (HALF + 1 + 31) / 32;  // bin pairs per lane
  constexpr float kInvN = 1.f / N_FFT;         // a power of two: exact
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_seg = N_FFT / hop;
  float2* tw = reinterpret_cast<float2*>(smem4);
  float* win = reinterpret_cast<float*>(tw + M);
  float* buf = win + N_FFT;          // one frame slot per warp
  float* rows = buf + kWarps * SF;   // hop-rows [r0, r0 + kFftTile)
  float* zre = buf + warp * SF;
  float* zim = zre + HP;
  const int n_local = kFftTile * hop;
  const int b = blockIdx.x / row_blocks;
  const int r0 = row_first + (blockIdx.x - b * row_blocks) * kFftTile;
  const size_t plane = static_cast<size_t>(b) * n_out * N_BINS;

  fft::load_twiddles(tw, tw_g, M);
  for (int i = threadIdx.x; i < N_FFT; i += kThreads) win[i] = window[i];
  for (int i = threadIdx.x; i < n_local; i += kThreads) rows[i] = 0.f;
  __syncthreads();

  // every output frame that touches the rows, one per warp
  const int v_begin = max(r0 - k_seg + 1, 0), v_end = min(r0 + kFftTile, n_out);
  for (int vb = v_begin; vb < v_end; vb += kWarps) {
    const int v = vb + warp;
    if (v < v_end) {
      const size_t o = plane + static_cast<size_t>(v) * N_BINS;
      // bin pairs (k, M - k), kLoadGroup per lane at once: all their loads
      // are issued before the first shared-memory store
      for (int i0 = 0; i0 < PAIRS; i0 += kLoadGroup) {
        float in[kLoadGroup][2][2];
#pragma unroll
        for (int g = 0; g < kLoadGroup; ++g) {
          const int k = min(lane + 32 * (i0 + g), HALF);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t q = o + (e ? M - k : k);
            in[g][e][0] = __ldg(s_re + q);
            in[g][e][1] = __ldg(s_im + q);
          }
        }
#pragma unroll
        for (int g = 0; g < kLoadGroup; ++g) {
          const int k = lane + 32 * (i0 + g);
          if (k > HALF) break;
          float2 xk = make_float2(in[g][0][0], in[g][0][1]), xm = make_float2(in[g][1][0], in[g][1][1]);
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
    // overlap-add: sample n of frame v lands at (v - r0)·hop + n of the
    // rows; each row sample adds the batch's frames in ascending order
    const int nb = min(kWarps, v_end - vb);
    const int p_end = min((vb + nb - 1 - r0) * hop + N_FFT, n_local);
    for (int p = max((vb - r0) * hop, 0) + threadIdx.x; p < p_end; p += kThreads) {
      float acc = rows[p];
      for (int s = 0; s < nb; ++s) {
        const int n = p - (vb + s - r0) * hop;
        if (n >= 0 && n < N_FFT) {
          const float* z = buf + s * SF + (n & 1) * HP;
          acc = fmaf(z[fft::padded(n >> 1)] * kInvN, win[n], acc);
        }
      }
      rows[p] = acc;
    }
    __syncthreads();
  }

  // local row sample i is sample r0·hop + i of the untrimmed stream
  for (int i = threadIdx.x; i < n_local; i += kThreads) {
    const long long j = static_cast<long long>(r0) * hop + i - M;  // trimmed index
    if (j >= 0 && j < out_len) out[static_cast<size_t>(b) * out_len + j] = rows[i] / norm[j];
  }
}

// --------------------------------------------------------- dense (a) analysis

__global__ void __launch_bounds__(kThreads, 2) dense_analysis_kernel(
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
        dst[n] = n < n_fft ? sample(src, base + n, t, half) : 0.f;
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

// z = unit(z·(cr, ci))
__device__ __forceinline__ void advance(float& zr, float& zi, float cr, float ci) {
  float nr = zr * cr - zi * ci, ni = zr * ci + zi * cr;
  unit(nr, ni, sqrtf(nr * nr + ni * ni));
  zr = nr;
  zi = ni;
}

// Frame f of a lane's (row, bin), frame f at rr[f * n_bins], with its magnitude.
__device__ __forceinline__ void fetch(const float* __restrict__ rr, const float* __restrict__ ri,
                                      int n_bins, int f, float& fr, float& fi, float& fm) {
  fr = __ldg(rr + static_cast<size_t>(f) * n_bins);
  fi = __ldg(ri + static_cast<size_t>(f) * n_bins);
  fm = sqrtf(fr * fr + fi * fi);
}

// Walks output frames [v0, v1) of one lane from the phase z: for each frame
// v, lo = (v·p)//q and frac = ((v·p) mod q)/q; with WRITE, s_v = mag·z with
// the magnitude interpolated between frames lo and lo + 1; then z advances
// by the unit increment phasor u[lo]. On return z is the phase of frame v1.
template <bool WRITE>
__device__ __forceinline__ void walk(const float* __restrict__ rr, const float* __restrict__ ri,
                                     float* __restrict__ sr, float* __restrict__ si, int n_bins,
                                     int v0, int v1, int p, int q, float& zr, float& zi) {
  if (v0 >= v1) return;
  int lo = static_cast<int>(static_cast<long long>(v0) * p / q);
  float ar, ai, am, br, bi, bm, ur, ui;
  fetch(rr, ri, n_bins, lo, ar, ai, am);
  fetch(rr, ri, n_bins, lo + 1, br, bi, bm);
  increment(ar, ai, am, br, bi, bm, ur, ui);
  const float inv_q = 1.f / static_cast<float>(q);
  for (int v = v0; v < v1; ++v) {
    const long long vp = static_cast<long long>(v) * p;
    const int want = static_cast<int>(vp / q);
    if (want != lo) {
      if (want == lo + 1) {
        ar = br, ai = bi, am = bm;
      } else {
        fetch(rr, ri, n_bins, want, ar, ai, am);
      }
      fetch(rr, ri, n_bins, want + 1, br, bi, bm);
      increment(ar, ai, am, br, bi, bm, ur, ui);
      lo = want;
    }
    if (WRITE) {
      const float frac = static_cast<float>(vp - static_cast<long long>(want) * q) * inv_q;
      const float mag = (1.f - frac) * am + frac * bm;
      sr[static_cast<size_t>(v) * n_bins] = mag * zr;
      si[static_cast<size_t>(v) * n_bins] = mag * zi;
    }
    advance(zr, zi, ur, ui);
  }
}

__global__ void __launch_bounds__(kSegments * 32) phase_kernel(
    const float* __restrict__ re, const float* __restrict__ im, float* __restrict__ s_re,
    float* __restrict__ s_im, int n_bins, int n_in, int n_out, int p, int q, int groups, int seg_len) {
  __shared__ float2 carry[kSegments][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int row = blockIdx.x / groups;
  const int k = (blockIdx.x - row * groups) * 32 + lane;
  const bool active = k < n_bins;
  const float* rr = re + static_cast<size_t>(row) * n_in * n_bins + k;
  const float* ri = im + static_cast<size_t>(row) * n_in * n_bins + k;
  float* sr = s_re + static_cast<size_t>(row) * n_out * n_bins + k;
  float* si = s_im + static_cast<size_t>(row) * n_out * n_bins + k;
  const int v0 = min(seg * seg_len, n_out), v1 = min(v0 + seg_len, n_out);

  // the product of the segment's increments, walked from 1 (the last
  // segment's is not needed)
  float pr = 1.f, pi = 0.f;
  if (active && seg + 1 < kSegments) walk<false>(rr, ri, nullptr, nullptr, n_bins, v0, v1, p, q, pr, pi);
  carry[seg][lane] = make_float2(pr, pi);
  __syncthreads();
  // the phase at each segment's first frame: unit(s[0]), then the carry
  // times each segment's product, renormalised at each boundary
  if (seg == 0 && active) {
    float zr, zi, zm;
    fetch(rr, ri, n_bins, 0, zr, zi, zm);
    unit(zr, zi, zm);
    for (int j = 0; j < kSegments; ++j) {
      const float2 c = carry[j][lane];
      carry[j][lane] = make_float2(zr, zi);
      advance(zr, zi, c.x, c.y);
    }
  }
  __syncthreads();
  if (active) {
    float zr = carry[seg][lane].x, zi = carry[seg][lane].y;
    walk<true>(rr, ri, sr, si, n_bins, v0, v1, p, q, zr, zi);
  }
}

// ------------------------------------------------------- dense (c) synthesis

__global__ void __launch_bounds__(kThreads) dense_synthesis_kernel(
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

// ------------------------------------------------------------------ launches

template <int LOG_M>
cudaError_t launch_fft(const float* x, const float* window, const float* tw, const double* tw64, const float* norm,
                       float* re, float* im, const float* s_re, const float* s_im, float* out,
                       long long frames, int batch, int t, int hop, int n_in, int n_out, int out_len,
                       bool analysis, cudaStream_t st) {
  const int n_fft = 2 << LOG_M;
  cudaError_t err;
  if (analysis) {
    const size_t smem = fft_analysis_smem(n_fft);
    err = cudaFuncSetAttribute(fft_analysis_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const long long per_block = static_cast<long long>(kWarps) * kFramesPerWarp;
    fft_analysis_kernel<LOG_M><<<static_cast<unsigned>((frames + per_block - 1) / per_block), kThreads, smem,
                                 st>>>(x, window, reinterpret_cast<const double2*>(tw64), re, im, frames, t, hop,
                                       n_in);
    return cudaGetLastError();
  }
  const size_t smem = fft_synthesis_smem(n_fft, hop);
  err = cudaFuncSetAttribute(fft_synthesis_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int row_first = (n_fft / 2) / hop;
  const int row_blocks = (n_out - row_first + kFftTile - 1) / kFftTile;
  fft_synthesis_kernel<LOG_M><<<static_cast<unsigned>(static_cast<long long>(batch) * row_blocks), kThreads,
                                smem, st>>>(s_re, s_im, window, reinterpret_cast<const float2*>(tw), norm, out, hop,
                                            n_out, out_len, row_first, row_blocks);
  return cudaGetLastError();
}

// the FFT path's analysis (analysis = true) or synthesis pass at n_fft
cudaError_t fft_pass(const float* x, const float* window, const float* tw, const double* tw64, const float* norm,
                     float* re,
                     float* im, const float* s_re, const float* s_im, float* out, long long frames, int batch,
                     int t, int n_fft, int hop, int n_in, int n_out, int out_len, bool analysis,
                     cudaStream_t st) {
  switch (half_log(n_fft)) {
#define AF_CASE(L)                                                                                  \
  case L:                                                                                           \
    return launch_fft<L>(x, window, tw, tw64, norm, re, im, s_re, s_im, out, frames, batch, t, hop, n_in, \
                         n_out, out_len, analysis, st);
    AF_CASE(3) AF_CASE(4) AF_CASE(5) AF_CASE(6) AF_CASE(7) AF_CASE(8) AF_CASE(9) AF_CASE(10)
#undef AF_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The FFT path's synthesis tile T (output hop-rows per block), or 0 for the
// dense path.
int timestretch_path(int n_fft, int hop) { return fft_tile(n_fft, hop); }

// Dynamic shared memory of the largest block of the path taken; the wrapper
// checks it against its own mirror and the card's limit.
long long timestretch_smem_bytes(int n_fft, int hop) {
  size_t a, c;
  if (fft_tile(n_fft, hop) > 0) {
    a = fft_analysis_smem(n_fft);
    c = fft_synthesis_smem(n_fft, hop);
  } else {
    a = dense_analysis_smem(n_fft);
    c = dense_synthesis_smem(n_fft, hop);
  }
  return static_cast<long long>(a > c ? a : c);
}

// Launches the three passes on `stream` and returns the first launch error
// (0 on success). Does not synchronise and allocates nothing. Needs hop |
// n_fft and t > n_fft / 2; n_in = (n_out - 1) * p / q + 2 and n_out =
// ceil((n_fft / 2 + out_len) / hop). The FFT path reads window, tw and tw64
// (the banks may be null); the dense path reads the banks (window, tw and
// tw64 may be null).
int timestretch_launch(const float* x, const float* window, const float* tw, const double* tw64, const float* cosb,
                       const float* sinb, const float* ciw, const float* siw, const float* norm, float* re,
                       float* im, float* s_re, float* s_im, float* out, int batch, int t, int n_fft, int hop,
                       int p, int q, int n_in, int n_out, int out_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bins = n_fft / 2 + 1;
  const long long frames = static_cast<long long>(batch) * n_in;
  const bool fft_path = fft_tile(n_fft, hop) > 0;
  cudaError_t err;

  if (fft_path) {
    err = fft_pass(x, window, tw, tw64, norm, re, im, s_re, s_im, out, frames, batch, t, n_fft, hop, n_in, n_out,
                   out_len, true, st);
  } else {
    const size_t smem = dense_analysis_smem(n_fft);
    err = cudaFuncSetAttribute(dense_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_analysis_kernel<<<static_cast<unsigned>((frames + kFrames - 1) / kFrames), kThreads, smem, st>>>(
        x, cosb, sinb, re, im, frames, t, n_fft, hop, n_bins, n_in);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int groups = (n_bins + 31) / 32;
  const int seg_len = (n_out + kSegments - 1) / kSegments;
  phase_kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * groups), kSegments * 32, 0, st>>>(
      re, im, s_re, s_im, n_bins, n_in, n_out, p, q, groups, seg_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if (fft_path)
    return static_cast<int>(fft_pass(x, window, tw, tw64, norm, re, im, s_re, s_im, out, frames, batch, t, n_fft, hop,
                                     n_in, n_out, out_len, false, st));
  const size_t smem = dense_synthesis_smem(n_fft, hop);
  err = cudaFuncSetAttribute(dense_synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_first = (n_fft / 2) / hop;
  const int row_blocks = (n_out - row_first + kRows - 1) / kRows;
  dense_synthesis_kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * row_blocks), kThreads, smem,
                           st>>>(s_re, s_im, ciw, siw, norm, out, n_fft, hop, n_bins, n_out, out_len, row_first,
                                 row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
