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
// pointer and row stride (any stride, odd ones too), so that a stream step
// needs no concatenation. Frame g = row * n_frames + f starts at sample
// f * hop of its row (any hop). The kernel also writes the new carry, the
// last c samples of each row, into a fresh [rows, c] tensor. An offline call
// is the same launch with c = 0: one segment, no carry.
//
// Designs (MelspecParams, built once per design set and device by the
// wrapper): window [n_fft] is the analysis window and tw [n_fft/2] float2
// the FFT twiddles (fft.cuh); cosb, sinb [n_fft, n_bins] are the
// window-folded DFT banks of the dense path. The filterbank comes as bands:
// bands [3, n_mels] int32 holds each mel column's first nonzero bin, its
// count of bins up to its last nonzero one (0 for an empty column), and the
// offset of its weights in wts, packed contiguously; max_band is the
// longest count. Only exact zeros outside each column's first-to-last range
// are skipped, so any filterbank works: the slaney bank at [513, 128] has
// 1,009 weights of 65,664, max_band 24. out [rows, n_frames, n_mels] is
// written as [rows * n_frames, n_mels].
//
// What bounds it: at the benchmark's step shape (2048 rows x 20 frames of
// 768 carried + 5120 new samples, n_fft 1024, 513 bins, 128 mels) the
// function reads 48.2 MB of signal and writes 21.0 MB of mel and 6.3 MB of
// carry, against about 1.25 GFLOP counted with an FFT and the bands, so
// bytes bound it (0.023 ms on an H100). The kernel is bound instead by each
// SM's instruction issue and shared-memory pipe, and by how many warps hide
// their latency: a frame's passes, split and band sums are some 1,300 warp
// instructions and 500 shared-memory wavefronts. The design before this one
// (a short-lived warp a frame, eight frames a block, four phases between
// two block barriers) took 0.177 ms on an H100: FFT 46%, band sums 26%,
// the frame loads through the carry/chunk select 10%, twiddle and window
// loads, stores and barriers 16%, carry 2%. Its pass twiddles conflicted 4-
// to 16-way on the banks, the band weights came through L1 from a dozen
// lines a load, and every sample was fetched by four frames. Two paths
// behind one C entry, chosen by shape (melspec_path):
//
// FFT path (power-of-two n_fft from 16 to 2048), staged runs: a run is F
// consecutive frames of one row, and its span of samples, (F-1)*hop +
// n_fft, is copied once into shared memory with cp.async, 16 bytes wide
// from the 16-byte-aligned address at or below each segment's start (the
// 0-3 float offset kept in the index; a carry whose offset differs from
// the chunk's, and each segment's 0-3 end samples, go 4 bytes wide). The
// carry/chunk select happens only there: a frame reads one contiguous span.
// A block walks steps of G runs (G = 1 unless runs are shorter than 8
// frames), with the next step's copies in flight while this step's frames
// are transformed (two buffers, one block barrier a step). A warp takes
// each frame from the staged span through window, FFT, power, band sums,
// floor and log, syncing with __syncwarp only; its lanes split the mels, so
// a frame's outputs go out in coalesced 128-byte stores. The window, the
// twiddles (a table a pass, laid out so that a warp's loads are
// conflict-free), the band table and the weights are loaded into shared
// memory once a block; the butterflies' inner twiddles are constants; a
// last pass of radix 2 (n_fft 64 and 1024) is fused with the real split;
// the band sums read a quad of powers and one of weights a load. A row's
// last run also stages the samples past its last frame, and the new carry
// is written from its staged span. F, G, the staging width and the warps a
// block are chosen from n_fft, hop and the row length (fft_plan; hop >=
// n_fft runs one frame each, staging no gap), and the grid from the SM
// count, queried once per device. Registers set the warps an SM holds: at
// 117 a thread one block of ten warps fitted and the kernel took 0.176 ms;
// capped at 96, two blocks fit, and it takes 0.124 ms at the step shape.

// Dense path (any other n_fft, such as 400 or 502): a block stages kFrames
// frames, its threads own kBinsPerThread bins for all of them (every bank
// value read from L2 feeds kFrames FMAs), the power rows go to shared memory,
// and threads over (mel, half of the frames) project them onto the bands.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

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
  int n_fft, hop, n_bins, n_mels, max_band, log_mode;
  float floor_;
};

// The FFT path's shape-dependent parameters, chosen on the host by
// fft_plan (ops/kernels/melspec.py mirrors it).
struct FftPlan {
  int frames;     // F: frames of a run (a row's last run may have fewer)
  int runs_row;   // runs a row
  int group;      // G: runs a step
  int warps;      // warps a block
  int stage;      // floats of one run's staging slot, a multiple of 4
  int wts_smem;   // 1: the weights are staged in shared memory, [max_band, n_mels]
  long long smem; // dynamic shared memory of a block, in bytes
};

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;
constexpr int kBinsPerThread = 2;
constexpr int kMelGroups = 2;  // frames split in the dense path's mel stage
constexpr int kFramesPerGroup = kFrames / kMelGroups;
constexpr int kMaxSmem = 232448;    // shared memory a block may use (227 KB)
constexpr int kSmSmem = 233472;     // shared memory of an SM (228 KB), 1 KB of it reserved a block
constexpr int kMaxWarps = 10;       // warps of an FFT-path block, at most: two blocks an SM
constexpr int kStepFrames = 8;      // frames a step holds at least, where runs are shorter
constexpr int kStageFloats = 6144;  // a run's staging slot, at most: the benchmark's 5,888-sample rows

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

// One frame's samples (the dense path's): sample k lies at lo + k where k <
// lim (in the carry), else at hi + k (in the chunk). A frame with lim <= 0
// lies wholly in the chunk, as every frame of an offline call does.
struct Frame {
  const float* lo;
  const float* hi;
  int lim;

  __device__ __forceinline__ float at(int k) const { return __ldg((k < lim ? lo : hi) + k); }
};

__device__ __forceinline__ Frame frame_of(const Args& a, long long g) {
  const long long row = g / a.n_frames;
  const int p0 = static_cast<int>(g - row * a.n_frames) * a.p.hop;
  return {a.carry + row * a.carry_row + p0, a.chunk + row * a.chunk_row + (p0 - a.c), a.c - p0};
}

// The new carry, the last c samples of each row, written by every thread of
// the grid (the dense path's).
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

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }


// float2 entries of the twiddle tables of the passes after the first (the
// first pass, over sub-length 1, has none): pass by pass, for r = 1..R-1
// and k < NS, the twiddle of point r of a butterfly at k.
__host__ __device__ constexpr int pass_twiddles(int log_m) {
  int total = 0;
  for (int ns = 0; ns < log_m;) {
    const int lr = log_m - ns >= 4 ? 4 : log_m - ns;
    if (ns > 0) total += ((1 << lr) - 1) << ns;
    ns += lr;
  }
  return total;
}

// Groups of 4 weights a band spans from the 4-float boundary at or below
// its first bin, at most: the staged weights are [quads(max_band), n_mels,
// 4], a band's weights from that boundary on, zeros around them, so that
// lanes over mels read a quad of weights and a quad of powers a load.
__host__ __device__ constexpr int quads(int max_band) { return (max_band + 6) / 4; }

// Offsets of a block's shared memory, in floats, each a multiple of 4 (16
// bytes): the window [n_fft], the real split's twiddles [m/2 + 1] float2,
// the passes' tables, the band table [3, n_mels], the weights where staged
// ([quads(max_band), n_mels, 4]), a frame slot a warp, and two step
// buffers of group slots of `stage` floats.
struct Layout {
  int tws, ptw, bands, wts, slots, stage, total;
};

__host__ __device__ inline Layout fft_layout(int log_m, int n_mels, int max_band, int wts_smem, int warps, int group,
                                             int stage) {
  const int m = 1 << log_m;
  Layout l;
  l.tws = 2 * m;
  l.ptw = l.tws + round4(2 * (m / 2 + 1));
  l.bands = l.ptw + round4(2 * pass_twiddles(log_m));
  l.wts = l.bands + round4(3 * n_mels);
  l.slots = l.wts + (wts_smem ? 4 * quads(max_band) * n_mels : 0);
  l.stage = l.slots + warps * round4(fft::slot_floats(m));
  l.total = l.stage + 2 * group * stage;
  return l;
}

// The FFT path's parameters for rows of t samples (c of them carried): the
// longest run whose span fits kStageFloats, runs of a row balanced; runs
// of one frame where frames do not overlap (hop >= n_fft), so that no gap
// is staged; G runs a step where runs are shorter than kStepFrames frames;
// a warp a frame of the step, up to kMaxWarps (then as many frames a warp
// as that takes, spread evenly); the weights staged where they fit.
FftPlan fft_plan(int n_fft, int hop, int t, int c, int n_mels, int max_band) {
  const int log_m = half_log(n_fft);
  const int nf = (t - n_fft) / hop + 1;
  FftPlan pl{};
  if (hop >= n_fft) {
    pl.frames = 1;
  } else {
    const int cap = std::min(nf, (kStageFloats - 4 - n_fft) / hop + 1);
    const int runs = (nf + cap - 1) / cap;
    pl.frames = (nf + runs - 1) / runs;
  }
  pl.runs_row = (nf + pl.frames - 1) / pl.frames;
  const int span = (pl.frames - 1) * hop + n_fft;
  // a row's last run stages the samples past its last frame too, for the new carry
  const int tail = c > 0 ? std::min(t - ((nf - 1) * hop + n_fft), kStageFloats - 4 - span) : 0;
  pl.stage = round4(span + tail + 3);  // + the 0-3 float offset
  pl.group = std::max(1, std::min((kStepFrames + pl.frames - 1) / pl.frames, kStageFloats / pl.stage));
  const int fs = pl.group * pl.frames, per_warp = (fs + kMaxWarps - 1) / kMaxWarps;
  const int want = (fs + per_warp - 1) / per_warp, slot = round4(fft::slot_floats(1 << log_m));
  auto room = [&](int wts_smem) {  // floats left for the frame slots
    return kMaxSmem / 4 - static_cast<long long>(fft_layout(log_m, n_mels, max_band, wts_smem, 0, pl.group, pl.stage).total);
  };
  pl.wts_smem = room(1) >= slot ? 1 : 0;
  pl.warps = static_cast<int>(std::max(1LL, std::min<long long>(want, room(pl.wts_smem) / slot)));
  pl.smem = 4LL * fft_layout(log_m, n_mels, max_band, pl.wts_smem, pl.warps, pl.group, pl.stage).total;
  return pl;
}

// e^{-2πi e/16}, the radix-8 and radix-16 butterflies' inner twiddles: cos
// and -sin of multiples of π/8 as fp32 constants, the float64 values rounded
// once (no fast-math sine or cosine).
__host__ __device__ constexpr float cos16(int e) {
  switch (e & 15) {
    case 0: return 1.f;
    case 1: case 15: return 0.923879532511286756f;
    case 2: case 14: return 0.707106781186547524f;
    case 3: case 13: return 0.382683432365089772f;
    case 4: case 12: return 0.f;
    case 5: case 11: return -0.382683432365089772f;
    case 6: case 10: return -0.707106781186547524f;
    case 7: case 9: return -0.923879532511286756f;
    default: return -1.f;
  }
}

__device__ __forceinline__ float2 w16(int e) { return make_float2(cos16(e), -cos16(e - 4)); }

// fft::dft with the inner twiddles as constants: DFT of R points in
// registers, o[k] = Σ_n v[n] W_R^{nk}, forward.
template <int R>
__device__ __forceinline__ void dft_c(float2 (&v)[R], float2 (&o)[R]) {
  if constexpr (R == 2) {
    fft::dft2(v[0], v[1]);
    o[0] = v[0];
    o[1] = v[1];
  } else if constexpr (R == 4) {
    fft::dft4<false>(v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = v[i];
  } else {
    constexpr int R1 = R / 4;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if constexpr (R1 == 2) fft::dft2(v[n2], v[4 + n2]);
      else fft::dft4<false>(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
    }
#pragma unroll
    for (int k1 = 1; k1 < R1; ++k1)
#pragma unroll
      for (int n2 = 1; n2 < 4; ++n2) {
        const int e = n2 * k1 * (16 / R);  // W^4 = -i: a swap and a sign
        const float2 x = v[4 * k1 + n2];
        v[4 * k1 + n2] = e == 4 ? make_float2(x.y, -x.x) : fft::cmul(x, w16(e));
      }
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      fft::dft4<false>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) o[k1 + R1 * k2] = v[4 * k1 + k2];
    }
  }
}

// The passes' twiddle tables, in pass order: for r = 1..R-1 and k < NS,
// fft::twiddle of r * k * (2m / (NS * R)), the value fft::warp_passes looks
// up for point r of the butterfly at k. A warp's butterflies read
// consecutive k, so the loads of one r are conflict-free.
template <int LOG_M>
__device__ __forceinline__ void load_pass_twiddles(float2* ptw, const float2* __restrict__ tw, int tid, int nthr) {
  constexpr int M = 1 << LOG_M;
  int off = 0;
  for (int ns = LOG_M >= 4 ? 4 : LOG_M; ns < LOG_M;) {
    const int lr = LOG_M - ns >= 4 ? 4 : LOG_M - ns;
    const int count = ((1 << lr) - 1) << ns, tstep = (2 * M) >> (ns + lr);
    for (int i = tid; i < count; i += nthr) {
      const int r = (i >> ns) + 1, k = i & ((1 << ns) - 1);
      ptw[off + i] = fft::twiddle<false>(tw, r * k * tstep, M);
    }
    off += count;
    ns += lr;
  }
}

// The first Stockham pass (sub-length 1), its points read from the staged
// frame x and windowed on the way: z[i] = x[2i]·w[2i] + i·x[2i+1]·w[2i+1].
// Writes the warp's slot (re, im) once the slot's last reader, the previous
// frame's band sums, is done. (Pairs read as one 8-byte load where the frame
// starts at an even float, and through a shuffle where it does not, ran
// 0.7% slower at the benchmark's step shape.)
template <int LOG_M>
__device__ __forceinline__ void first_pass(const float* x, const float* win, float* re, float* im, int lane) {
  constexpr int M = 1 << LOG_M, LOG_R = LOG_M >= 4 ? 4 : LOG_M, R = 1 << LOG_R, Q = M >> LOG_R;
  constexpr int NB = Q >= 32 ? Q / 32 : 1;
  const bool active = Q >= 32 || lane < Q;
  float2 v[NB][R];
  if (active) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * b + r * Q;
        const float2 w = reinterpret_cast<const float2*>(win)[i];
        v[b][r] = make_float2(x[2 * i] * w.x, x[2 * i + 1] * w.y);
      }
  }
  __syncwarp();
  if (active) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float2 o[R];
      dft_c<R>(v[b], o);
      const int at = fft::padded((lane + 32 * b) << LOG_R);  // its R outputs lie in one run of 32
#pragma unroll
      for (int r = 0; r < R; ++r) {
        re[at + r] = o[r].x;
        im[at + r] = o[r].y;
      }
    }
  }
  __syncwarp();
}

// fft::warp_passes from sub-length 2^LOG_NS up to 2^LOG_END, forward, with
// each pass's twiddles from its table (ptw, the pass's first) and the inner
// ones constant. Its slot indices are a lane's base and constant offsets:
// padded(x + c) = padded(x) + padded(c) wherever x % 32 + c % 32 < 32, as
// for a load's lane + 32b + rQ (lane < Q) and a store's dst + r NS (dst %
// 32 < 16 where NS = 16).
template <int LOG_M, int LOG_NS, int LOG_END>
__device__ __forceinline__ void passes(float* re, float* im, const float2* ptw, int lane) {
  if constexpr (LOG_NS < LOG_END) {
    constexpr int LOG_R = LOG_M - LOG_NS >= 4 ? 4 : LOG_M - LOG_NS;
    constexpr int M = 1 << LOG_M, R = 1 << LOG_R, Q = M >> LOG_R, NS = 1 << LOG_NS;
    constexpr int NB = Q >= 32 ? Q / 32 : 1;
    const bool active = Q >= 32 || lane < Q;
    float2 v[NB][R];
    if (active) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = lane + fft::padded(32 * b + r * Q);
          v[b][r] = make_float2(re[i], im[i]);
        }
    }
    __syncwarp();
    if (active) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = lane + 32 * b, k = j & (NS - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) v[b][r] = fft::cmul(v[b][r], ptw[(r - 1) * NS + k]);
        float2 o[R];
        dft_c<R>(v[b], o);
        const int at = fft::padded(((j - k) << LOG_R) + k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          re[at + fft::padded(r * NS)] = o[r].x;
          im[at + fft::padded(r * NS)] = o[r].y;
        }
      }
    }
    __syncwarp();
    passes<LOG_M, LOG_NS + LOG_R, LOG_END>(re, im, ptw + (R - 1) * NS, lane);
  }
}

// fft::real_forward on values in registers: the powers of bins k and
// m - k of the real transform from zk = Z[k], zc = Z[m-k] and w = tw[k].
// The split's halvings are taken out and the powers quartered instead:
// scaling by a power of 2 is exact, so the bits are real_forward's.
__device__ __forceinline__ void split_power(float2 zk, float2 zc, float2 w, float& pk, float& pc) {
  const float2 b = make_float2(zc.x, -zc.y);  // conj Z[m-k]
  const float2 e = make_float2(zk.x + b.x, zk.y + b.y);
  const float2 o = make_float2(zk.y - b.y, -(zk.x - b.x));  // -i (a - b)
  const float2 wo = fft::cmul(w, o);
  const float2 xk = make_float2(e.x + wo.x, e.y + wo.y);
  const float2 xc = make_float2(e.x - wo.x, wo.y - e.y);  // conj(e - wo)
  pk = 0.25f * (xk.x * xk.x + xk.y * xk.y);
  pc = 0.25f * (xc.x * xc.x + xc.y * xc.y);
}

// The power spectrum of the transformed slot, bins 0..M written over zre.
template <int LOG_M>
__device__ __forceinline__ void power(float* zre, const float* zim, const float2* tws, int lane) {
  constexpr int M = 1 << LOG_M, HALF = M / 2, PAIRS = (HALF + 1 + 31) / 32;
  float pk[PAIRS], pc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int k = lane + 32 * i, kc = (M - k) & (M - 1);
    if (k <= HALF)
      split_power(make_float2(zre[fft::padded(k)], zim[fft::padded(k)]),
                  make_float2(zre[fft::padded(kc)], zim[fft::padded(kc)]), tws[k], pk[i], pc[i]);
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
  __syncwarp();
}

// The last pass, where it is of radix 2 (NS = M/2), fused with the real
// split and the power: task t < NS/2 runs the butterflies at t and NS - t,
// which give Z[t], Z[NS + t], Z[NS - t] and Z[M - t], the four values the
// split of bins t and NS - t needs, and writes the powers of bins t, M - t,
// NS - t and NS + t over zre; task 0 runs the butterflies at 0 and NS/2,
// whose outputs pair with themselves (bins 0, M, NS, NS/2 and 3NS/2). The
// arithmetic is the unfused path's; the slot is written once instead of
// twice and read once less.
template <int LOG_M>
__device__ __forceinline__ void power_r2(float* zre, const float* zim, const float2* ptw, const float2* tws, int lane) {
  constexpr int M = 1 << LOG_M, NS = M / 2, TASKS = NS / 2, ROUNDS = (TASKS + 31) / 32;
  float pw[ROUNDS][4], p0 = 0.f;
  const int rb = fft::padded(NS - lane);  // padded(NS - t) = rb - 33u, padded(M - t) = rb + padded(NS) - 33u
#pragma unroll
  for (int u = 0; u < ROUNDS; ++u) {
    const int t = lane + 32 * u, t2 = t == 0 ? NS / 2 : NS - t;
    if (t < TASKS) {
      const int i0 = lane + fft::padded(32 * u), i1 = lane + fft::padded(32 * u + NS);
      const int i2 = t == 0 ? fft::padded(NS / 2) : rb - 33 * u;
      const int i3 = t == 0 ? fft::padded(NS + NS / 2) : rb + fft::padded(NS) - 33 * u;
      const float2 b = fft::cmul(make_float2(zre[i1], zim[i1]), ptw[t]);
      const float2 d = fft::cmul(make_float2(zre[i3], zim[i3]), ptw[t2]);
      const float2 a = make_float2(zre[i0], zim[i0]), c = make_float2(zre[i2], zim[i2]);
      const float2 z0 = make_float2(a.x + b.x, a.y + b.y), z1 = make_float2(a.x - b.x, a.y - b.y);
      const float2 z2 = make_float2(c.x + d.x, c.y + d.y), z3 = make_float2(c.x - d.x, c.y - d.y);
      if (t == 0) {  // Z[0] and Z[NS] pair with themselves, Z[NS/2] with Z[3NS/2]
        split_power(z0, z0, tws[0], pw[u][0], pw[u][1]);
        split_power(z1, z1, tws[NS], pw[u][2], p0);
        split_power(z2, z3, tws[NS / 2], pw[u][3], p0);
      } else {
        split_power(z0, z3, tws[t], pw[u][0], pw[u][1]);
        split_power(z2, z1, tws[t2], pw[u][2], pw[u][3]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < ROUNDS; ++u) {
    const int t = lane + 32 * u;
    if (t < TASKS) {
      zre[t] = pw[u][0];
      if (t == 0) {
        zre[M] = pw[u][1];
        zre[NS] = pw[u][2];
        zre[NS / 2] = pw[u][3];
        zre[NS + NS / 2] = p0;
      } else {
        zre[M - t] = pw[u][1];
        zre[NS - t] = pw[u][2];
        zre[NS + t] = pw[u][3];
      }
    }
  }
  __syncwarp();
}

// The frame's n_mels outputs from the power spectrum in zre: the band sums,
// floor and log, lanes over mels, each band summed in bin order. kSmemWts:
// the weights lie in shared memory as [max_band, n_mels]; else packed in
// device memory.
template <bool kSmemWts>
__device__ __forceinline__ void mel_sums(const float* zre, const int* bands, const float* wts, float* out,
                                         const Args& a, int lane) {
  const int n_mels = a.p.n_mels;
  for (int mel = lane; mel < n_mels; mel += 32) {
    const int lo = bands[mel], count = bands[n_mels + mel];
    float acc = 0.f;
    if constexpr (kSmemWts) {  // in quads from lo's 4-float boundary: the zeros around the band add exact zeros
      const float4* pw = reinterpret_cast<const float4*>(zre + (lo & ~3));
      const float4* w = reinterpret_cast<const float4*>(wts) + mel;
      const int n4 = count > 0 ? ((lo & 3) + count + 3) >> 2 : 0;
      for (int j = 0; j < n4; ++j) {
        const float4 p = pw[j], q = w[j * n_mels];
        acc = fmaf(p.x, q.x, acc);
        acc = fmaf(p.y, q.y, acc);
        acc = fmaf(p.z, q.z, acc);
        acc = fmaf(p.w, q.w, acc);
      }
    } else {
      const float* pw = zre + lo;
      const float* w = wts + bands[2 * n_mels + mel];
      for (int i = 0; i < count; ++i) acc = fmaf(pw[i], __ldg(w + i), acc);
    }
    out[mel] = finish(acc, a.p.floor_, a.p.log_mode);
  }
}

// A float pointer's offset from the 16-byte boundary at or below it, in floats
__device__ __forceinline__ int phase4(const float* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n samples from src (device memory, any float alignment) to dst (shared
// memory), by the block's threads. wide: dst and src share their offset
// from a 16-byte boundary, so all but 0-3 samples at each end go 16 bytes
// a copy, from and to 16-byte-aligned addresses.
__device__ __forceinline__ void stage_segment(float* dst, const float* src, int n, bool wide, int tid, int nthr) {
  const int head = wide ? min(n, (4 - phase4(src)) & 3) : n;
  const int body = wide ? (n - head) >> 2 : 0;
  for (int i = tid; i < head; i += nthr) cp_async4(dst + i, src + i);
  for (int i = tid; i < body; i += nthr) cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + tid; i < n; i += nthr) cp_async4(dst + i, src + i);
}

// Run `run` of the launch: frames [f0, f0 + nfr) of a row, its samples
// [s, e) staged in its slot from float sh on (0-3: the chunk's offset from
// a 16-byte boundary at sample s, so that the chunk goes 16 bytes wide). A
// row's last run stages up to the row's end where there is a carry to write
// and its slot holds it.
struct Run {
  long long row;
  int f0, nfr, s, e, sh;
  bool last;
};

__device__ __forceinline__ Run run_of(const Args& a, const FftPlan& pl, long long run) {
  Run r;
  r.row = pl.runs_row == 1 ? run : run / pl.runs_row;
  const int ri = static_cast<int>(run - r.row * pl.runs_row);
  r.last = ri == pl.runs_row - 1;
  r.f0 = ri * pl.frames;
  r.nfr = min(pl.frames, a.n_frames - r.f0);
  r.s = r.f0 * a.p.hop;
  r.e = r.s + (r.nfr - 1) * a.p.hop + a.p.n_fft;
  if (a.c > 0 && r.last) r.e = static_cast<int>(min(static_cast<long long>(a.t), r.s + pl.stage - 3LL));
  r.sh = static_cast<int>((reinterpret_cast<unsigned long long>(a.chunk) / sizeof(float) +
                           static_cast<unsigned long long>(r.row * a.chunk_row + r.s - a.c)) & 3);
  return r;
}

// Issues the copies of a run's samples into its slot: the carry's part
// (16 bytes wide where its offset matches the chunk's), then the chunk's.
__device__ __forceinline__ void stage_run(const Args& a, const Run& r, float* slot, int tid, int nthr) {
  float* dst = slot + r.sh;
  if (r.s < a.c) {
    const float* src = a.carry + r.row * a.carry_row + r.s;
    stage_segment(dst, src, min(r.e, a.c) - r.s, phase4(src) == r.sh, tid, nthr);
  }
  if (r.e > a.c) {
    const int p = max(r.s, a.c);
    stage_segment(dst + (p - r.s), a.chunk + r.row * a.chunk_row + (p - a.c), r.e - p, true, tid, nthr);
  }
}

// The new carry of a row's last run, the row's last c samples: from its
// staged span, and from the segments for any sample outside it (a carry
// longer than the span).
__device__ __forceinline__ void carry_from_stage(const Args& a, const Run& r, const float* slot, int tid, int nthr) {
  float* dst = a.new_carry + r.row * a.c;
  for (int i = tid; i < a.c; i += nthr) {
    const int p = a.t - a.c + i;
    float v;
    if (p >= r.s && p < r.e) v = slot[r.sh + (p - r.s)];
    else if (p < a.c) v = __ldg(a.carry + r.row * a.carry_row + p);
    else v = __ldg(a.chunk + r.row * a.chunk_row + (p - a.c));
    dst[i] = v;
  }
}

// Two blocks of up to kMaxWarps warps an SM: 96 registers a thread.
template <int LOG_M>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) melspec_fft_kernel(const Args a, const FftPlan pl) {
  constexpr int M = 1 << LOG_M, LOG_R0 = LOG_M >= 4 ? 4 : LOG_M;
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the copies
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int n_mels = a.p.n_mels;
  const Layout l = fft_layout(LOG_M, n_mels, a.p.max_band, pl.wts_smem, pl.warps, pl.group, pl.stage);
  const float* win = sm;
  float2* tws = reinterpret_cast<float2*>(sm + l.tws);
  float2* ptw = reinterpret_cast<float2*>(sm + l.ptw);
  int* bands = reinterpret_cast<int*>(sm + l.bands);
  float* wts = sm + l.wts;
  float* zre = sm + l.slots + warp * round4(fft::slot_floats(M));
  float* zim = zre + fft::padded(M);
  const long long runs = static_cast<long long>(a.rows) * pl.runs_row;
  const long long steps = (runs + pl.group - 1) / pl.group;
  const int step_floats = pl.group * pl.stage;

  // the block's first step in flight while the designs load
  long long step = blockIdx.x;
  for (int g = 0; g < pl.group && step * pl.group + g < runs; ++g)
    stage_run(a, run_of(a, pl, step * pl.group + g), sm + l.stage + g * pl.stage, tid, nthr);
  cp_async_commit();
  for (int i = tid; i < 2 * M; i += nthr) sm[i] = __ldg(a.p.window + i);
  for (int i = tid; i <= M / 2; i += nthr) tws[i] = __ldg(a.p.tw + i);
  load_pass_twiddles<LOG_M>(ptw, a.p.tw, tid, nthr);
  for (int i = tid; i < 3 * n_mels; i += nthr) bands[i] = __ldg(a.p.bands + i);
  for (int i = tid; i < l.stage - l.slots; i += nthr) sm[l.slots + i] = 0.f;  // the quads past bin M read pads
  if (pl.wts_smem) {
    for (int i = tid; i < 4 * quads(a.p.max_band) * n_mels; i += nthr) {
      const int j4 = (i >> 2) / n_mels, mel = (i >> 2) - j4 * n_mels;
      const int k = 4 * j4 + (i & 3) - (__ldg(a.p.bands + mel) & 3);  // the weight's place in its band
      wts[i] = k >= 0 && k < __ldg(a.p.bands + n_mels + mel) ? __ldg(a.p.wts + __ldg(a.p.bands + 2 * n_mels + mel) + k)
                                                             : 0.f;
    }
  }

  for (int it = 0; step < steps; ++it, step += gridDim.x) {
    const float* buf = sm + l.stage + (it & 1) * step_floats;
    cp_async_wait_all();
    __syncthreads();  // this step's samples landed, and every warp is done with the other buffer
    const long long next = step + gridDim.x;
    for (int g = 0; g < pl.group && next < steps && next * pl.group + g < runs; ++g)
      stage_run(a, run_of(a, pl, next * pl.group + g), sm + l.stage + ((it + 1) & 1) * step_floats + g * pl.stage,
                tid, nthr);
    cp_async_commit();
    if (a.c > 0) {
      for (int g = 0; g < pl.group && step * pl.group + g < runs; ++g) {
        const Run r = run_of(a, pl, step * pl.group + g);
        if (r.last) carry_from_stage(a, r, buf + g * pl.stage, tid, nthr);
      }
    }
    Run r;
    int rg = -1;  // the run r describes
    for (int q = warp; q < pl.group * pl.frames; q += pl.warps) {
      const int g = q / pl.frames, f = q - g * pl.frames;
      if (step * pl.group + g >= runs) break;
      if (g != rg) {
        r = run_of(a, pl, step * pl.group + g);
        rg = g;
      }
      if (f >= r.nfr) continue;
      first_pass<LOG_M>(buf + g * pl.stage + r.sh + f * a.p.hop, win, zre, zim, lane);
      if constexpr (LOG_M % 4 == 1) {  // the last pass of radix 2 (n_fft 64 and 1024), fused with the split
        passes<LOG_M, LOG_R0, LOG_M - 1>(zre, zim, ptw, lane);
        power_r2<LOG_M>(zre, zim, ptw + pass_twiddles(LOG_M) - M / 2, tws, lane);
      } else {
        passes<LOG_M, LOG_R0, LOG_M>(zre, zim, ptw, lane);
        power<LOG_M>(zre, zim, tws, lane);
      }
      float* out = a.out + (r.row * a.n_frames + r.f0 + f) * n_mels;
      if (pl.wts_smem) mel_sums<true>(zre, bands, wts, out, a, lane);
      else mel_sums<false>(zre, bands, a.p.wts, out, a, lane);
    }
  }
}

// SMs of the calling thread's device, queried once per device
int sm_count(int dev) {
  static std::atomic<int> sms[64];
  std::atomic<int>& slot = sms[dev & 63];
  int n = slot.load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 1;
    slot.store(n, std::memory_order_relaxed);
  }
  return n;
}

// Blocks an SM holds, by its registers (allocated 256 a warp), warps,
// shared memory and block slots.
int blocks_per_sm(int regs, int warps, long long smem) {
  const int regs_warp = (regs * 32 + 255) / 256 * 256;
  const int by_regs = regs_warp > 0 ? 65536 / regs_warp / warps : 32;
  const int by_smem = static_cast<int>(kSmSmem / (smem + 1024));
  return std::max(1, std::min({by_regs, by_smem, 64 / warps, 32}));
}

template <int LOG_M>
cudaError_t launch_fft(const Args& a, const FftPlan& pl, cudaStream_t st) {
  // per instance: the shared-memory ceiling raised once per device, the
  // registers a thread read once
  static std::atomic<unsigned long long> raised{0};
  static std::atomic<int> regs{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(melspec_fft_kernel<LOG_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, melspec_fft_kernel<LOG_M>);
    if (err != cudaSuccess) return err;
    regs.store(fa.numRegs, std::memory_order_relaxed);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const long long steps = (static_cast<long long>(a.rows) * pl.runs_row + pl.group - 1) / pl.group;
  const long long grid = std::min<long long>(
      steps, static_cast<long long>(sm_count(dev)) * blocks_per_sm(regs.load(std::memory_order_relaxed), pl.warps, pl.smem));
  melspec_fft_kernel<LOG_M><<<static_cast<unsigned>(grid), pl.warps * 32, static_cast<size_t>(pl.smem), st>>>(a, pl);
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

// 1 where n_fft takes the FFT path, 0 where it takes the dense path.
int melspec_path(int n_fft) { return half_log(n_fft) >= 0 ? 1 : 0; }

// Dynamic shared memory one block of the dense path needs; the wrapper
// checks it against its own mirror and the card's limit.
long long melspec_smem_bytes(int n_fft, int n_bins) { return static_cast<long long>(dense_smem(n_fft, n_bins)); }

// The FFT path's plan for rows of t samples, c of them carried: fields[6]
// gets frames, runs_row, group, warps, stage and wts_smem; returns its
// shared memory a block. For the wrapper's check of its mirror.
long long melspec_fft_plan(int n_fft, int hop, int t, int c, int n_mels, int max_band, int* fields) {
  const FftPlan pl = fft_plan(n_fft, hop, t, c, n_mels, max_band);
  const int f[6] = {pl.frames, pl.runs_row, pl.group, pl.warps, pl.stage, pl.wts_smem};
  for (int i = 0; i < 6; ++i) fields[i] = f[i];
  return pl.smem;
}

// sizeof(MelspecParams), for the wrapper's check of its mirror.
int melspec_params_bytes() { return static_cast<int>(sizeof(MelspecParams)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. Each of `rows` rows is c samples of
// `carry` (carry_row apart) then n samples of `chunk` (chunk_row apart);
// with c = 0 the carry is never read and new_carry may be null. Writes
// out [rows, n_frames, n_mels] and new_carry [rows, c], both contiguous;
// the wrapper has checked that c + n >= n_fft, that c + n and rows are
// below 2**31, and that the path's shared memory fits.
int melspec_launch(const MelspecParams* params, const float* carry, long long carry_row, int c,
                   const float* chunk, long long chunk_row, int n, float* out, float* new_carry, int rows,
                   void* stream) {
  const MelspecParams& p = *params;
  const int t = c + n, n_frames = (t - p.n_fft) / p.hop + 1;
  const Args a{p, carry, chunk, out, new_carry, carry_row, chunk_row,
               static_cast<long long>(rows) * n_frames, rows, c, t, n_frames};
  if (a.total <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log_m = half_log(p.n_fft);
  if (log_m >= 0) {
    const FftPlan pl = fft_plan(p.n_fft, p.hop, t, c, p.n_mels, p.max_band);
    if (pl.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaErrorInvalidValue;
    switch (log_m) {
#define AF_CASE(L) \
  case L:          \
    err = launch_fft<L>(a, pl, st); \
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
