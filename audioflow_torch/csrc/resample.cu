// The streaming polyphase resampler's step for Hopper (sm_90a), fp32 throughout.
//
// Replaces no TPU kernel: the JAX package leaves the resampler's banded
// product to XLA (a dot over shifted reshapes), and the port ran the same
// product through cuBLAS: the carry and the chunk concatenated, padded, cut
// into two stride-ipb segments, copied contiguous, two dense sgemms against
// the [ipb + K, G] band and their sum. The band is 82% zeros at 44.1 to 16
// kHz. This kernel computes the step directly, in one launch:
//   y[r, b*G + g] = sum_t bank[p_g, t] * buf[r, b*ipb + base_g + t]
// where buf is the carry's hist samples followed by the chunk, and the
// phase p_g and offset base_g repeat every G outputs (ops/resample.py's
// StreamResamplePlan). It also writes the new carry, buf's last hist
// samples. The carry and the chunk are read from their own pointers, the
// chunk at any row stride, so neither the concatenation nor a contiguous
// copy is needed.
//
// Tables (ops/kernels/resample.py, once per plan): outputs in groups of
// kJ = 8 consecutive g. Group q's window starts at qbase[q] = base_{8q};
// its coefficients are shifted to that start and padded with zeros to a
// common span, ct [span][2][n_groups][4] (float4 per half group), so that
// output j of group q reads ct[s][j/4][q][j%4] against buf[qbase[q] + s].
// Every output sums over s = 0..span-1 in that order, whatever the launch
// shape or the row stride: the sums are deterministic, and both paths below
// give the same bits (the padded zeros add exact zeros). Nothing atomic.
//
// What bounds it: at the benchmark's step shape ([2048, 14112] at 44.1 to
// 16 kHz: K 97, G 160, ipb 441, hist 95) the step reads 116.4 MB (chunk and
// carry) and writes 41.9 MB (output) and 0.8 MB (carry): 0.0475 ms at 3.35
// TB/s. The useful arithmetic is 2 x 2048 x 5120 x 97 = 2.03 GFLOP, 0.030
// ms at 67 TFLOP/s; with the span's padding (117 of 97 taps) 0.037 ms. So
// bytes bound it, the FMAs close behind, and the design has to read each
// input once, coalesced, and keep the FMA units fed from shared memory.
//
// Tile path (a window that fits shared memory): a block owns 32 rows and
// one block b of G outputs. It stages the rows' window (qbase[last] + span
// samples from b*ipb on) transposed, position-major with 36 floats a
// position (32 rows and a pad), in 16-byte loads that bypass L1 where the
// chunk's rows allow them, kStage of them in flight a thread. A thread
// computes 4 rows x 8 outputs: per window position one 16-byte shared load
// (its 4 rows) and two 16-byte loads of the group's coefficients feed 32
// FMAs, each step's loads issued a step ahead. A warp holds 8 row sets x 4
// groups: the 8 row sets of a group read one contiguous 128-byte position,
// so the loads are free of bank conflicts for any plan, and so are the
// staging stores (a half warp writes 16 rows of one position). The
// coefficients are read through L1 (the read-only path; the table is 75 KB
// at 44.1 to 16 kHz): they are the same for every tile, while shared memory
// goes to the windows, 78 KB a block at 44.1 to 16 kHz, so that two blocks
// share an SM. On the H100 the step takes about 0.18 ms at the shape above,
// a quarter of its bound: the FMA pass alone runs at 44% of the fp32 peak,
// and the staging does not hide behind it (PERF.md has what was tried).
//
// Generic path (a window too wide for shared memory, such as 96 to 8 kHz's
// 385 taps): a thread an output, reading the carry, the chunk and the table
// through L1, with the same sums.

#include <cuda_runtime.h>

// A plan's launch parameters, built once per plan and device by the wrapper
// (ops/kernels/resample.py mirrors this layout); outside the unnamed
// namespace, so that resample_launch keeps C linkage.
struct ResampleParams {
  const float4* ct;        // [span][2][n_groups] float4
  const int* qbase;        // [n_groups]
  int chunk_in, hist, ipb, g, n_groups, span, window, n_blocks;
};

namespace {

constexpr int kJ = 8;                     // outputs of a group, a thread's columns
constexpr int kR = 4;                     // rows a thread
constexpr int kCols = 4;                  // groups a warp
constexpr int kRowsets = 32 / kCols;      // row sets a warp
constexpr int kTileRows = kR * kRowsets;  // rows a block
constexpr int kLd = kTileRows + 4;        // floats a staged position (16-byte aligned, bank-shifted)
constexpr int kMaxWarps = 6;              // two blocks an SM at up to 170 registers a thread
constexpr int kStage = 8;                 // 16-byte loads a thread keeps in flight while staging
constexpr int kGenericThreads = 256;
constexpr size_t kMaxSmem = 232448;       // shared memory one block may use on Hopper

struct Args {
  ResampleParams p;
  const float* chunk;      // [rows] at chunk_row apart, chunk_in samples each
  const float* carry;      // [rows] at carry_row apart, hist samples each
  float* y;                // [rows, n_blocks * g], contiguous
  float* new_carry;        // [rows, hist], contiguous
  long long chunk_row, carry_row;
  int rows, vec_in;
};

// Staged positions a block allocates: the window, up to 3 positions ahead of
// it for 16-byte alignment, rounded up to whole pairs of quads.
int positions(int window) { return (window + 3 + 7) / 8 * 8; }

size_t tile_smem(int window) { return static_cast<size_t>(positions(window)) * kLd * sizeof(float); }

// buf[row, p]: the carry's hist samples, then the chunk, zeros outside.
__device__ __forceinline__ float buf_at(const Args& a, long long row, long long p) {
  if (p < 0) return 0.f;
  if (p < a.p.hist) return __ldg(a.carry + row * a.carry_row + p);
  p -= a.p.hist;
  return p < a.p.chunk_in ? __ldg(a.chunk + row * a.chunk_row + p) : 0.f;
}

// Staging item `it` of a block: a half warp takes 16 rows of one quad of
// positions, the other half the same rows of the next quad.
__device__ __forceinline__ int stage_row(int it) { return (it & 15) | (((it >> 5) & 1) << 4); }
__device__ __forceinline__ int stage_quad(int it) { return ((it >> 6) << 1) | ((it >> 4) & 1); }

struct Tile {
  long long row0, p0;  // the block's first row and first buf position
  int b, e;            // its block of outputs; staged position u holds buf[p0 - e + u]
};

// Stages the block's rows' window, transposed: kStage 16-byte loads a thread
// in flight, then their shared-memory stores.
__device__ __forceinline__ void stage_window(float* xs, const Args& a, const Tile& t) {
  const int items = (t.e + a.p.window + 7) / 8 * 2 * kTileRows;
  for (int first = threadIdx.x; first < items; first += kStage * blockDim.x) {
    float4 v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int it = first + k * blockDim.x;
      const long long row = t.row0 + stage_row(it);
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (it < items && row < a.rows) {
        const long long p = t.p0 - t.e + 4 * stage_quad(it);
        const long long c = p - a.p.hist;
        if (a.vec_in && c >= 0 && c + 4 <= a.p.chunk_in) {
          v[k] = __ldcg(reinterpret_cast<const float4*>(a.chunk + row * a.chunk_row + c));
        } else {
          v[k] = make_float4(buf_at(a, row, p), buf_at(a, row, p + 1), buf_at(a, row, p + 2), buf_at(a, row, p + 3));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int it = first + k * blockDim.x;
      if (it < items) {
        float* dst = xs + 4 * stage_quad(it) * kLd + stage_row(it);
        dst[0] = v[k].x;
        dst[kLd] = v[k].y;
        dst[2 * kLd] = v[k].z;
        dst[3 * kLd] = v[k].w;
      }
    }
  }
}

// acc += the group's taps against its rows' staged inputs, s = 0..span-1 in
// order. Each step's loads are issued a step ahead of their FMAs.
__device__ __forceinline__ void accumulate(const float* xp, const float4* cp, int n_groups, int span,
                                           float (&acc)[kR][kJ]) {
  float4 xv = *reinterpret_cast<const float4*>(xp);
  float4 c0 = __ldg(cp), c1 = __ldg(cp + n_groups);
#pragma unroll 4
  for (int s = 0; s < span; ++s) {
    const int sn = min(s + 1, span - 1);
    const float4 xn = *reinterpret_cast<const float4*>(xp + sn * kLd);
    const float4 n0 = __ldg(cp + (2 * sn) * n_groups);
    const float4 n1 = __ldg(cp + (2 * sn + 1) * n_groups);
    const float xr[kR] = {xv.x, xv.y, xv.z, xv.w};
    const float cr[kJ] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(xr[i], cr[j], acc[i][j]);
    xv = xn;
    c0 = n0;
    c1 = n1;
  }
}

__device__ __forceinline__ void write_out(const Args& a, const Tile& t, int q, int rs, const float (&acc)[kR][kJ]) {
  const long long n_out = static_cast<long long>(a.p.n_blocks) * a.p.g;
  const int g0 = q * kJ;
  const bool whole = n_out % 4 == 0 && a.p.g % 4 == 0 && g0 + kJ <= a.p.g;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const long long row = t.row0 + kR * rs + i;
    if (row >= a.rows) continue;
    float* out = a.y + row * n_out + static_cast<long long>(t.b) * a.p.g + g0;
    if (whole) {
      reinterpret_cast<float4*>(out)[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(out)[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    } else {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (g0 + j < a.p.g) out[j] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2) resample_tile_kernel(const Args a) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the row-set reads
  float* xs = reinterpret_cast<float*>(smem4);
  Tile t;
  t.b = blockIdx.x % a.p.n_blocks;
  t.row0 = static_cast<long long>(blockIdx.x / a.p.n_blocks) * kTileRows;
  t.p0 = static_cast<long long>(t.b) * a.p.ipb;
  t.e = static_cast<int>(((t.p0 - a.p.hist) % 4 + 4) % 4);
  stage_window(xs, a, t);
  if (t.b == a.p.n_blocks - 1) {  // the new carry: buf's last hist samples
    for (int it = threadIdx.x; it < kTileRows * a.p.hist; it += blockDim.x) {
      const long long row = t.row0 + it / a.p.hist;
      const int i = it % a.p.hist;
      if (row < a.rows) a.new_carry[row * a.p.hist + i] = buf_at(a, row, static_cast<long long>(a.p.chunk_in) + i);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, col = lane >> 3, rs = lane & 7;
  for (int gq = threadIdx.x >> 5; gq * kCols < a.p.n_groups; gq += blockDim.x >> 5) {
    const int q_live = gq * kCols + col;
    const int q = min(q_live, a.p.n_groups - 1);  // a lane past the last group computes it again, unwritten
    float acc[kR][kJ];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
    accumulate(xs + (t.e + __ldg(a.p.qbase + q)) * kLd + kR * rs, a.p.ct + q, a.p.n_groups, a.p.span, acc);
    if (q_live < a.p.n_groups) write_out(a, t, q, rs, acc);
  }
}

__global__ void __launch_bounds__(kGenericThreads) resample_generic_kernel(const Args a) {
  const long long n_out = static_cast<long long>(a.p.n_blocks) * a.p.g;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < static_cast<long long>(a.rows) * a.p.hist) {
    const long long row = idx / a.p.hist;
    a.new_carry[idx] = buf_at(a, row, a.p.chunk_in + (idx - row * a.p.hist));
  }
  if (idx >= a.rows * n_out) return;
  const long long row = idx / n_out, m = idx - row * n_out;
  const int b = static_cast<int>(m / a.p.g), g = static_cast<int>(m - static_cast<long long>(b) * a.p.g);
  const int q = g / kJ, j = g % kJ;
  const long long p = static_cast<long long>(b) * a.p.ipb + __ldg(a.p.qbase + q);
  const float* cp = reinterpret_cast<const float*>(a.p.ct + (j / 4) * a.p.n_groups + q) + j % 4;
  float acc = 0.f;
  for (int s = 0; s < a.p.span; ++s)
    acc = fmaf(buf_at(a, row, p + s), __ldg(cp + static_cast<long long>(s) * 8 * a.p.n_groups), acc);
  a.y[idx] = acc;
}

}  // namespace

extern "C" {

// 1 where a window of `window` positions takes the tile path, 0 where it
// takes the generic path.
int resample_path(int window) { return tile_smem(window) <= kMaxSmem ? 1 : 0; }

// sizeof(ResampleParams), for the wrapper's check of its mirror.
int resample_params_bytes() { return static_cast<int>(sizeof(ResampleParams)); }

// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise and allocates nothing. `vec_in` promises that the chunk's
// pointer is 16-byte aligned and its row stride a multiple of 4 floats.
int resample_launch(const ResampleParams* params, const float* chunk, long long chunk_row, const float* carry,
                    long long carry_row, float* y, float* new_carry, int rows, int vec_in, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ResampleParams& p = *params;
  const Args a{p, chunk, carry, y, new_carry, chunk_row, carry_row, rows, vec_in};
  if (resample_path(p.window)) {
    const size_t smem = tile_smem(p.window);
    cudaError_t err = cudaFuncSetAttribute(resample_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int quads = (p.n_groups + kCols - 1) / kCols;
    const long long tiles = static_cast<long long>(p.n_blocks) * ((rows + kTileRows - 1) / kTileRows);
    resample_tile_kernel<<<static_cast<unsigned>(tiles), (quads < kMaxWarps ? quads : kMaxWarps) * 32, smem, st>>>(a);
  } else {
    const long long work = static_cast<long long>(rows) * p.n_blocks * p.g;
    const long long carry_items = static_cast<long long>(rows) * p.hist;
    const long long items = work > carry_items ? work : carry_items;
    resample_generic_kernel<<<static_cast<unsigned>((items + kGenericThreads - 1) / kGenericThreads),
                              kGenericThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
