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
// Design. The Pallas kernel walks a sequential grid over frames and keeps
// the [2B, W] messages in VMEM, the band as lane rotations. Here one block
// owns one batch row and loops over all frames inside the launch: the
// merge mixes only the two tracks of one row and bin, so rows never talk.
// The block keeps both tracks' messages in shared memory, double buffered
// as [2][2][n_bins + 2*half] with -1e30 margins, so one __syncthreads() per
// frame separates the reads of frame t-1's messages from the writes of
// frame t's. Threads own bins; neighbouring threads read neighbouring
// shared words (no bank conflicts) and write the backpointers coalesced
// along the bins.
//
// What bounds it: per frame and state, 2*half+1 adds and compares. At the
// pYIN defaults (626 frames, 64 rows, 602 bins, 139 taps) that is 13.4 G
// operations, 0.20 ms at the card's 67 TFLOP/s fp32 rate, against 289 MB
// moved (0.086 ms), so operations bound it. This kernel runs 64 blocks on
// 132 SMs and issues about five instructions per tap; splitting a row over
// a thread-block cluster with a halo exchange per frame is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kMaxThreads) viterbi_forward_kernel(
    const float* __restrict__ obs_v, const float* __restrict__ obs_u, const float* __restrict__ lk_g,
    float* __restrict__ dv_out, float* __restrict__ du_out, int8_t* __restrict__ off,
    int8_t* __restrict__ pick, int n_frames, int batch, int n_bins, int kernel_len, float log_init,
    float log_stay, float log_switch) {
  extern __shared__ float smem[];
  const int half = (kernel_len - 1) / 2;
  const int ld = n_bins + 2 * half;  // one track's padded messages
  float* lk = smem;                   // [kernel_len]
  float* msg = smem + kernel_len;     // [2 buffers][2 tracks][ld]
  const int b = blockIdx.x;

  for (int i = threadIdx.x; i < kernel_len; i += blockDim.x) lk[i] = lk_g[i];
  for (int i = threadIdx.x; i < 4 * ld; i += blockDim.x) {
    const int j = i % ld - half;
    float v = kNeg;
    if (i < 2 * ld && j >= 0 && j < n_bins) {  // buffer 0 holds frame 0
      const size_t o = static_cast<size_t>(b) * n_bins + j;
      v = (i < ld ? obs_v[o] : obs_u[o]) + log_init;
    }
    msg[i] = v;
  }
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * n_bins + j;
    const size_t track = static_cast<size_t>(batch) * n_bins;
    off[o] = 0;
    off[o + track] = 0;
    pick[o] = 0;
    pick[o + track] = 0;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < n_frames; ++t) {
    const float* qv = msg + cur * 2 * ld;  // padded: bin j's band starts at qv[j]
    const float* qu = qv + ld;
    float* nv = msg + (1 - cur) * 2 * ld + half;
    float* nu = nv + ld;
    const size_t row = (static_cast<size_t>(t) * batch + b) * n_bins;
    const size_t out_v = (static_cast<size_t>(t) * 2 * batch + b) * n_bins;
    const size_t out_u = out_v + static_cast<size_t>(batch) * n_bins;
    for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
      const float lv = obs_v[row + j];  // issued before the band, used after it
      const float lu = obs_u[row + j];
      float bv = qv[j] + lk[0], bu = qu[j] + lk[0];
      int av = 0, au = 0;
      for (int k = 1; k < kernel_len; ++k) {
        const float cv = qv[j + k] + lk[k];
        const float cu = qu[j + k] + lk[k];
        if (cv > bv) {
          bv = cv;
          av = k;
        }
        if (cu > bu) {
          bu = cu;
          au = k;
        }
      }
      const float sv = bv + log_stay, su = bu + log_switch;
      const bool pick_v = su > sv;
      nv[j] = lv + (pick_v ? su : sv);
      const float sv2 = bv + log_switch, su2 = bu + log_stay;
      const bool pick_u = su2 > sv2;
      nu[j] = lu + (pick_u ? su2 : sv2);
      off[out_v + j] = static_cast<int8_t>((pick_v ? au : av) - half);
      off[out_u + j] = static_cast<int8_t>((pick_u ? au : av) - half);
      pick[out_v + j] = pick_v ? 1 : 0;
      pick[out_u + j] = pick_u ? 1 : 0;
    }
    cur = 1 - cur;
    __syncthreads();
  }

  const float* qv = msg + cur * 2 * ld + half;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    dv_out[static_cast<size_t>(b) * n_bins + j] = qv[j];
    du_out[static_cast<size_t>(b) * n_bins + j] = qv[ld + j];
  }
}

size_t smem_bytes(int n_bins, int kernel_len) {
  return (static_cast<size_t>(4) * (n_bins + kernel_len - 1) + kernel_len) * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block; the wrapper checks it against its own
// mirror and the card's limit.
long long viterbi_smem_bytes(int n_bins, int kernel_len) {
  return static_cast<long long>(smem_bytes(n_bins, kernel_len));
}

// The whole forward pass: one launch on `stream`, one block per batch row.
// Returns the launch error (0 on success). Does not synchronise and
// allocates nothing. Needs n_frames >= 1, batch >= 1, n_bins >= 1 and an odd
// kernel_len <= 255 whose viterbi_smem_bytes fits the card.
int viterbi_forward_launch(const float* obs_v, const float* obs_u, const float* lk, float* dv,
                           float* du, int8_t* off, int8_t* pick, int n_frames, int batch, int n_bins,
                           int kernel_len, float log_init, float log_stay, float log_switch,
                           void* stream) {
  const size_t smem = smem_bytes(n_bins, kernel_len);
  cudaError_t err = cudaFuncSetAttribute(viterbi_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (n_bins + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  viterbi_forward_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs_v, obs_u, lk, dv, du, off, pick, n_frames, batch, n_bins, kernel_len, log_init, log_stay,
      log_switch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
