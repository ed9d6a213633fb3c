// Real FFT in shared memory, forward and inverse, fp32, shared by melspec.cu
// and griffinlim.cu.
//
// A length-n real transform (n = 2m, a power of two, 16 <= n <= 2048) is a
// length-m complex Stockham FFT of z[j] = x[2j] + i·x[2j+1], followed by the
// real-split post-twiddle; the inverse runs the pre-twiddle first. One warp
// transforms one frame, so the passes need __syncwarp() and no block
// barrier. Each pass is radix 16 while 4 or more bits of m are left, then
// one pass of radix 2, 4 or 8 (m = 512: 16, 16, 2): a lane loads its
// butterflies' points into registers, the warp syncs, and the lane writes
// the pass's outputs back in place. The frame's slot holds its m real parts
// then its m imaginary parts, padded by one float every 32 so that the
// passes' strided writes spread over the banks.
//
// The twiddles e^{-2πi t/n}, t < m, are designed on the host in float64 and
// rounded to fp32 (ops/kernels/fft.py::twiddles), and serve the passes, the
// radix-8 and radix-16 butterflies' inner twiddles and the real split;
// exponents past m use e^{-2πi (t+m)/n} = -e^{-2πi t/n}. No fast-math sine
// or cosine is used. Conventions of the bank form (ops/stft.py): forward
// e^{-iωn}, unscaled; the inverse weighs bins 1..m-1 twice over n and
// ignores the imaginary parts of bin 0 and bin m.

#pragma once

#include <cuda_runtime.h>

namespace fft {

constexpr int kMinLogM = 3;   // n_fft 16
constexpr int kMaxLogM = 10;  // n_fft 2048: the largest the registers hold

// index of element i of a frame's real or imaginary parts, one pad every 32
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

// floats of one frame's slot: m real parts, then m imaginary parts, padded
__host__ __device__ constexpr int slot_floats(int m) { return 2 * padded(m); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{∓2πi t/(2m)} (INV: +) for 0 <= t < 2m from the half-circle table tw [m]
template <bool INV>
__device__ __forceinline__ float2 twiddle(const float2* tw, int t, int m) {
  const float2 w = tw[t < m ? t : t - m];
  const float s = t < m ? 1.f : -1.f;
  return make_float2(s * w.x, INV ? -s * w.y : s * w.y);
}

// Copies the twiddle table [m] into shared memory; the caller syncs.
__device__ __forceinline__ void load_twiddles(float2* dst, const float2* __restrict__ src, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = src[i];
}

template <bool INV>
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}

// in place, natural order: forward X1 = b - i·d, X3 = b + i·d; INV swaps them
template <bool INV>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 a = make_float2(x0.x + x2.x, x0.y + x2.y), b = make_float2(x0.x - x2.x, x0.y - x2.y);
  const float2 c = make_float2(x1.x + x3.x, x1.y + x3.y), d = make_float2(x1.x - x3.x, x1.y - x3.y);
  const float2 bmid = make_float2(b.x + d.y, b.y - d.x), bpid = make_float2(b.x - d.y, b.y + d.x);
  x0 = make_float2(a.x + c.x, a.y + c.y);
  x2 = make_float2(a.x - c.x, a.y - c.y);
  x1 = INV ? bpid : bmid;
  x3 = INV ? bmid : bpid;
}

// DFT of R points in registers, o[k] = Σ_n v[n] W_R^{±nk}. R = 8 and 16 are
// R1 x 4 (R1 = 2, 4): n = 4·n1 + n2, k = k1 + R1·k2; DFT_R1 over n1, the
// inner twiddles W_R^{n2·k1}, DFT_4 over n2. m is the FFT's length.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R], float2 (&o)[R], const float2* tw, int m) {
  if constexpr (R == 2) {
    dft2<INV>(v[0], v[1]);
    o[0] = v[0];
    o[1] = v[1];
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = v[i];
  } else {
    constexpr int R1 = R / 4;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if constexpr (R1 == 2) dft2<INV>(v[n2], v[4 + n2]);
      else dft4<INV>(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
    }
    // now v[4·k1 + n2] holds the R1-point output k1 of column n2
#pragma unroll
    for (int k1 = 1; k1 < R1; ++k1)
#pragma unroll
      for (int n2 = 1; n2 < 4; ++n2)
        v[4 * k1 + n2] = cmul(v[4 * k1 + n2], twiddle<INV>(tw, n2 * k1 * (2 * m / R), m));
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      dft4<INV>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) o[k1 + R1 * k2] = v[4 * k1 + k2];
    }
  }
}

// The Stockham passes from sub-length 2^LOG_NS on, in place on one frame's
// slot (re, im), by the 32 lanes of one warp.
template <int LOG_M, int LOG_NS, bool INV>
__device__ __forceinline__ void warp_passes(float* re, float* im, const float2* tw, int lane) {
  if constexpr (LOG_NS < LOG_M) {
    constexpr int LOG_R = LOG_M - LOG_NS >= 4 ? 4 : LOG_M - LOG_NS;
    constexpr int M = 1 << LOG_M, R = 1 << LOG_R, Q = M >> LOG_R, NS = 1 << LOG_NS;
    constexpr int NB = Q >= 32 ? Q / 32 : 1;            // butterflies per lane
    constexpr int TSTEP = (2 * M) >> (LOG_NS + LOG_R);  // twiddle step, in 1/(2m) turns
    const bool active = Q >= 32 || lane < Q;
    float2 v[NB][R];
    if (active) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = padded(lane + 32 * b + r * Q);
          v[b][r] = make_float2(re[i], im[i]);
        }
    }
    __syncwarp();
    if (active) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = lane + 32 * b, k = j & (NS - 1);
        if constexpr (NS > 1) {
#pragma unroll
          for (int r = 1; r < R; ++r) v[b][r] = cmul(v[b][r], twiddle<INV>(tw, r * k * TSTEP, M));
        }
        float2 o[R];
        dft<R, INV>(v[b], o, tw, M);
        const int dst = ((j - k) << LOG_R) + k;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          re[padded(dst + r * NS)] = o[r].x;
          im[padded(dst + r * NS)] = o[r].y;
        }
      }
    }
    __syncwarp();
    warp_passes<LOG_M, LOG_NS + LOG_R, INV>(re, im, tw, lane);
  }
}

// Length-2^LOG_M complex FFT of one frame's slot by one warp, in place, in
// natural order; forward e^{-2πi/m}, INV e^{+2πi/m}, both unscaled. Syncs
// the warp before it reads the slot and after it writes it.
template <int LOG_M, bool INV>
__device__ __forceinline__ void warp_fft(float* re, float* im, const float2* tw, int lane) {
  __syncwarp();
  warp_passes<LOG_M, 0, INV>(re, im, tw, lane);
}

// Real-split post-twiddle: bins X[k] and X[m-k] (for k = 0, X[m]) of the
// length-2m real transform whose packed complex FFT Z sits in (zre, zim),
// for 0 <= k <= m/2.
__device__ __forceinline__ void real_forward(const float* zre, const float* zim, int k, int m,
                                             const float2* tw, float2& xk, float2& xc) {
  const int kc = (m - k) & (m - 1);
  const float2 a = make_float2(zre[padded(k)], zim[padded(k)]);
  const float2 b = make_float2(zre[padded(kc)], -zim[padded(kc)]);  // conj Z[m-k]
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
  const float2 o = make_float2(0.5f * (a.y - b.y), -0.5f * (a.x - b.x));  // -i (a - b) / 2
  const float2 wo = cmul(tw[k], o);
  xk = make_float2(e.x + wo.x, e.y + wo.y);
  xc = make_float2(e.x - wo.x, wo.y - e.y);  // conj(e - wo)
}

// Real-split pre-twiddle of the inverse: from bins xk = X[k] and xm = X[m-k]
// (for k = 0, X[m]; the caller zeroes their imaginary parts) the packed
// spectrum Z[k] and Z[m-k], for 0 <= k <= m/2. The unscaled inverse FFT of Z
// is n times the inverse real transform, even samples in the real parts.
__device__ __forceinline__ void real_inverse(float2 xk, float2 xm, int k, const float2* tw,
                                             float2& zk, float2& zc) {
  const float2 e = make_float2(xk.x + xm.x, xk.y - xm.y);  // X[k] + conj X[m-k]
  const float2 dd = make_float2(xk.x - xm.x, xk.y + xm.y);  // X[k] - conj X[m-k]
  const float2 w = tw[k];
  const float2 o = cmul(dd, make_float2(w.x, -w.y));
  zk = make_float2(e.x - o.y, e.y + o.x);  // e + i·o
  zc = make_float2(e.x + o.y, o.x - e.y);  // conj(e - i·o)
}

}  // namespace fft
