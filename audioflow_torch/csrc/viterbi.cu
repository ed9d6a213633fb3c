// The pYIN two-track banded max-plus Viterbi forward pass for Hopper (sm_90a).
//
// Replaces audioflow_tpu/ops/pallas/viterbi.py::pyin_viterbi_forward (the
// Pallas kernel `_kernel`). For every batch row and every frame t >= 1, on
// both tracks' messages (voiced dv, unvoiced du):
//   band:  acc[j] = max_k q[j + k - half] + lk[k], k = 0..2*half, sources
//          outside [0, n_bins) read -1e30; a candidate replaces acc only if
//          it is strictly greater, so ties keep the lowest offset;
//   merge: sv = bv + log_stay, su = bu + log_switch, pick_v = su > sv,
//          new_v = obs_v + (pick_v ? su : sv), off_v = pick_v ? au : av,
//          and the same with stay and switch exchanged for the unvoiced
//          track (ops/pitch.py:498-505 of the JAX package, literally).
// Frame 0 is obs + log_init with zero backpointers. Outputs: the final
// messages dv, du [batch, n_bins], and per frame the centred offset
// (off - half, exact in int8 up to 255 taps) and the unvoiced-source flag,
// int8 [n_frames, 2, batch, n_bins].
//
// Layout: obs_v, obs_u [n_frames, batch, n_bins] f32; lk [kernel_len] f32.
//
// Bit-identity with the plain version and the JAX scan: there are no
// multiplies, so no FMA contraction can apply; every constant arrives as an
// f32 (a double argument would promote the sums); the sums keep the order
// q[src] + lk[k], (b + log_stay) against (b + log_switch), obs + merged.
// Build without --use_fast_math.
//
// What bounds it: per frame and state, 2*half+1 adds and compares. At the
// pYIN defaults (626 frames, 64 rows, 602 bins, 139 taps) that is 13.6 G
// operations, 0.20 ms at the card's 67 TFLOP/s fp32 rate, against 290 MB
// moved (0.086 ms): operations bound it, and the frames are sequential. In
// practice the issue rate does: a tap costs an add, a compare and two
// selects per state, and each row's frames wait for each other.
//
// Design. The Pallas kernel walks a sequential grid over frames and keeps
// the [2B, W] messages in VMEM, the band as lane rotations. Here each batch
// row is a thread-block cluster of C blocks that loops over all frames
// inside one launch: the merge mixes only the two tracks of one row and bin,
// so rows never talk, and C (viterbi_cluster) is chosen by shape so that
// batch x C blocks fill the card's 132 SMs, at most the portable 8. Block c
// owns bins [c*nb, (c+1)*nb) of its row and keeps both tracks' messages of
// its bins in shared memory, double buffered, with half-wide margins that
// hold its neighbours' edge bins (-1e30 past the row's ends). After a block
// computes frame t, it writes each new message that lies in another block's
// margins into that block's shared memory (distributed shared memory,
// map_shared_rank); where nb < half a margin spans more than one neighbour
// and a bin goes to each block that reads it. One cluster barrier per frame
// then replaces the single block's __syncthreads(): double buffering keeps
// the reads of frame t-1's messages apart from the writes of frame t's, so
// the tap loop reads local shared memory only. A cluster of one block
// (batch >= 132) keeps __syncthreads(), which costs less.
//
// A thread owns kR = 2 consecutive bins and slides one window of kR source
// messages per track over the taps in registers: each tap loads one message
// per track and one log-transition value, shared by 2·kR candidates. kS = 2
// adjacent lanes split a bin's taps into two runs and merge their maxima in
// ascending tap order with a strict compare (a shuffle), which restores the
// warps per SM that kR takes away. The candidates are the same single f32
// adds whatever the split, so the result is the same bits. The taps are
// padded to a multiple of kR·kS with -inf, which no candidate ever loses to.
// kR = kS = 2 was chosen by timing the nine (R, S) in {1, 2, 4}^2 at the pYIN
// shape on the H100 (PERF.md); a split barrier (arrive, the
// backpointer stores, wait) measured slower than one cluster.sync() a frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;     // shared memory one block may use on Hopper
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kTargetSms = 132;      // the H100's SMs, a constant of the rule so that Python mirrors it
constexpr int kR = 2;                // consecutive bins a thread owns
constexpr int kS = 2;                // lanes that split a bin's taps
constexpr int kPad = kR;             // slabs padded to a multiple of kR
constexpr int kTapPad = kR * kS;     // taps padded so that each lane's run is a multiple of kR
constexpr float kNeg = -1e30f;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// floats of one track's messages in one buffer: nb bins and both margins,
// padded for the sliding windows
__host__ __device__ inline int slab(int nb, int kernel_len) {
  return round_up(nb, kPad) + round_up(kernel_len, kTapPad) + kPad;
}

size_t smem_bytes(int nb, int kernel_len) {
  return static_cast<size_t>(round_up(kernel_len, kTapPad) + 4 * slab(nb, kernel_len)) * sizeof(float);
}

// Blocks per row: batch x C near the SM count, at most kMaxCluster, grown
// until a block's messages fit in shared memory, then cut to the blocks that
// own bins; 0 if none fits.
int cluster_size(int batch, int n_bins, int kernel_len) {
  if (batch < 1 || n_bins < 1 || kernel_len < 1) return 0;
  int want = kTargetSms / batch;
  want = want < 1 ? 1 : (want > kMaxCluster ? kMaxCluster : want);
  for (int c = want; c <= kMaxCluster; ++c) {
    const int nb = (n_bins + c - 1) / c;
    if (smem_bytes(nb, kernel_len) <= static_cast<size_t>(kMaxSmem)) return (n_bins + nb - 1) / nb;
  }
  return 0;
}

// The band of R consecutive bins on both tracks over n_taps taps (a
// multiple of R): qv, qu point at the first bin's first source of the taps in
// the padded messages, lk at their first tap (-inf past the real ones);
// the offsets are relative to the first tap.
template <int R>
__device__ __forceinline__ void band(const float* __restrict__ qv, const float* __restrict__ qu,
                                     const float* __restrict__ lk, int n_taps, float (&bv)[R], int (&av)[R],
                                     float (&bu)[R], int (&au)[R]) {
  float wv[R], wu[R];  // wv[s % R] holds qv[s] for the R sources of the current tap
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wv[r] = qv[r];
    wu[r] = qu[r];
    bv[r] = bu[r] = -__int_as_float(0x7f800000);
    av[r] = au[r] = 0;
  }
#pragma unroll 4
  for (int k0 = 0; k0 < n_taps; k0 += R) {
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const int k = k0 + kk;
      const float l = lk[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float cv = wv[(r + kk) % R] + l;
        const float cu = wu[(r + kk) % R] + l;
        if (cv > bv[r]) {
          bv[r] = cv;
          av[r] = k;
        }
        if (cu > bu[r]) {
          bu[r] = cu;
          au[r] = k;
        }
      }
      wv[kk] = qv[k + R];  // source k is done; source k + R enters
      wu[kk] = qu[k + R];
    }
  }
}

// Merges the maxima of S tap parts held by S adjacent lanes, in ascending tap
// order: a higher part's candidate wins only if strictly greater. Every lane
// of the S ends with the merged (best, arg).
template <int S>
__device__ __forceinline__ void merge_parts(float& best, int& arg, int part) {
#pragma unroll
  for (int w = 1; w < S; w <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, w);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, w);
    const bool take = (part & w) ? !(best > ob) : ob > best;  // the other part is the lower one, or the higher
    best = take ? ob : best;
    arg = take ? oa : arg;
  }
}

__global__ void __launch_bounds__(kMaxThreads) viterbi_forward_kernel(
    const float* __restrict__ obs_v, const float* __restrict__ obs_u, const float* __restrict__ lk_g,
    float* __restrict__ dv_out, float* __restrict__ du_out, int8_t* __restrict__ off,
    int8_t* __restrict__ pick, int n_frames, int batch, int n_bins, int kernel_len, int nb, float log_init,
    float log_stay, float log_switch) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int half = (kernel_len - 1) / 2;
  const int k_pad = round_up(kernel_len, kTapPad);
  const int ld = slab(nb, kernel_len);
  const int part_taps = k_pad / kS;    // a multiple of kR
  const int part = threadIdx.x % kS;   // the kS parts of a bin group sit on adjacent lanes
  const int n_cluster = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_cluster;
  const int base = rank * nb;                 // the block's first bin
  const int own = min(nb, n_bins - base);     // bins it owns
  const int groups = (own + kR - 1) / kR;     // threads' bin groups
  float* lk = smem;                           // [k_pad]
  float* msg = smem + k_pad;                  // [2 buffers][2 tracks][ld]; local bin i at half + i

  for (int i = threadIdx.x; i < k_pad; i += blockDim.x)
    lk[i] = i < kernel_len ? lk_g[i] : -__int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < 4 * ld; i += blockDim.x) {
    const int li = i % ld - half, j = base + li;  // local and global bin
    float v = kNeg;
    if (i < 2 * ld && li < own + half && j >= 0 && j < n_bins) {  // buffer 0 holds frame 0
      const size_t o = static_cast<size_t>(b) * n_bins + j;
      v = (i < ld ? obs_v[o] : obs_u[o]) + log_init;
    }
    msg[i] = v;
  }
  for (int i = threadIdx.x; i < own; i += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * n_bins + base + i;
    const size_t track = static_cast<size_t>(batch) * n_bins;
    off[o] = 0;
    off[o + track] = 0;
    pick[o] = 0;
    pick[o + track] = 0;
  }
  // a cluster barrier costs more than a block barrier: a cluster of one
  // block (batch >= 132) takes the block barrier
  if (n_cluster > 1) cluster.sync();
  else __syncthreads();  // every block's buffers are set before any block writes into them

  const int step = blockDim.x / kS;  // bin groups a pass of the block covers
  int cur = 0;
  for (int t = 1; t < n_frames; ++t) {
    const float* qv = msg + cur * 2 * ld;  // padded: local bin i's band starts at qv[i]
    const float* qu = qv + ld;
    const int next = (1 - cur) * 2 * ld + half;  // local bin i of frame t at msg[next + i]
    const size_t row = (static_cast<size_t>(t) * batch + b) * n_bins + base;
    const size_t out_v = (static_cast<size_t>(t) * 2 * batch + b) * n_bins + base;
    const size_t out_u = out_v + static_cast<size_t>(batch) * n_bins;
    // the same trip count for every thread: the parts' shuffles need whole warps
    for (int g0 = 0; g0 < groups; g0 += step) {
      const int g = g0 + static_cast<int>(threadIdx.x) / kS;
      const int i0 = g < groups ? g * kR : 0;  // lanes past the bins compute bin 0 and store nothing
      float lv[kR], lu[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {  // issued before the band, used after it
        const bool ok = g < groups && i0 + r < own;
        lv[r] = ok ? obs_v[row + i0 + r] : 0.f;
        lu[r] = ok ? obs_u[row + i0 + r] : 0.f;
      }
      float bv[kR], bu[kR];
      int av[kR], au[kR];
      const int k_lo = part * part_taps;
      band<kR>(qv + i0 + k_lo, qu + i0 + k_lo, lk + k_lo, part_taps, bv, av, bu, au);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        av[r] += k_lo;
        au[r] += k_lo;
        merge_parts<kS>(bv[r], av[r], part);
        merge_parts<kS>(bu[r], au[r], part);
      }
      if (g >= groups || part != 0) continue;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = i0 + r;
        if (i >= own) break;
        const float sv = bv[r] + log_stay, su = bu[r] + log_switch;
        const bool pick_v = su > sv;
        const float new_v = lv[r] + (pick_v ? su : sv);
        const float sv2 = bv[r] + log_switch, su2 = bu[r] + log_stay;
        const bool pick_u = su2 > sv2;
        const float new_u = lu[r] + (pick_u ? su2 : sv2);
        msg[next + i] = new_v;
        msg[next + ld + i] = new_u;
        off[out_v + i] = static_cast<int8_t>((pick_v ? au[r] : av[r]) - half);
        off[out_u + i] = static_cast<int8_t>((pick_u ? au[r] : av[r]) - half);
        pick[out_v + i] = pick_v ? 1 : 0;
        pick[out_u + i] = pick_u ? 1 : 0;
        if (i < half || i >= own - half) {
          // an edge bin: into the margins of every other block that reads it
          const int j = base + i;
          for (int d = 0; d < n_cluster; ++d) {
            const int li = j - d * nb;
            if (d == rank || li < -half || li >= min(nb, n_bins - d * nb) + half) continue;
            float* remote = cluster.map_shared_rank(msg, d);
            remote[next + li] = new_v;
            remote[next + ld + li] = new_u;
          }
        }
      }
    }
    cur = 1 - cur;
    if (n_cluster > 1) cluster.sync();
    else __syncthreads();
  }

  const float* qv = msg + cur * 2 * ld + half;
  for (int i = threadIdx.x; i < own; i += blockDim.x) {
    dv_out[static_cast<size_t>(b) * n_bins + base + i] = qv[i];
    du_out[static_cast<size_t>(b) * n_bins + base + i] = qv[ld + i];
  }
}

cudaError_t launch(const float* obs_v, const float* obs_u, const float* lk, float* dv, float* du, int8_t* off,
                   int8_t* pick, int n_frames, int batch, int n_bins, int kernel_len, float log_init,
                   float log_stay, float log_switch, int cluster, cudaStream_t st) {
  const int nb = (n_bins + cluster - 1) / cluster;
  const size_t smem = smem_bytes(nb, kernel_len);
  cudaError_t err = cudaFuncSetAttribute(viterbi_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int threads = ((nb + kR - 1) / kR * kS + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, viterbi_forward_kernel, obs_v, obs_u, lk, dv, du, off, pick, n_frames, batch,
                           n_bins, kernel_len, nb, log_init, log_stay, log_switch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per batch row (the cluster size C), 0 where no block fits.
int viterbi_cluster(int batch, int n_bins, int kernel_len) { return cluster_size(batch, n_bins, kernel_len); }

// Dynamic shared memory of one block at the cluster size taken; the wrapper
// checks it against its own mirror and the card's limit.
long long viterbi_smem_bytes(int batch, int n_bins, int kernel_len) {
  const int c = cluster_size(batch, n_bins, kernel_len);
  if (c == 0) return -1;
  return static_cast<long long>(smem_bytes((n_bins + c - 1) / c, kernel_len));
}

// The whole forward pass: one launch on `stream`, one cluster of
// viterbi_cluster blocks per batch row. Returns the launch error (0 on
// success). Does not synchronise and allocates nothing. Needs n_frames >= 1,
// batch >= 1, n_bins >= 1 and an odd kernel_len <= 255 with viterbi_cluster
// > 0.
int viterbi_forward_launch(const float* obs_v, const float* obs_u, const float* lk, float* dv,
                           float* du, int8_t* off, int8_t* pick, int n_frames, int batch, int n_bins,
                           int kernel_len, float log_init, float log_stay, float log_switch, void* stream) {
  const int c = cluster_size(batch, n_bins, kernel_len);
  if (c == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(obs_v, obs_u, lk, dv, du, off, pick, n_frames, batch, n_bins, kernel_len,
                                 log_init, log_stay, log_switch, c, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
