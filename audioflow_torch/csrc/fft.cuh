// Real FFT in shared memory, forward and inverse, shared by melspec.cu,
// griffinlim.cu and timestretch.cu: fp32, and the forward transform in fp64
// too (T = double, double2 values and twiddles) for timestretch's analysis.
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
// rounded to fp32, or kept in fp64 (ops/kernels/fft.py::twiddles), and serve the passes, the
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

// values of one frame's slot: m real parts, then m imaginary parts, padded
__host__ __device__ constexpr int slot_floats(int m) { return 2 * padded(m); }

// the complex value type of a real type: float2 or double2
template <typename T> struct complex_of;
template <> struct complex_of<float> { using type = float2; };
template <> struct complex_of<double> { using type = double2; };
template <typename T> using c2 = typename complex_of<T>::type;

template <typename V, typename S>
__device__ __forceinline__ V cplx(S x, S y) {
  V r;
  r.x = x;
  r.y = y;
  return r;
}

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return cplx<V>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{∓2πi t/(2m)} (INV: +) for 0 <= t < 2m from the half-circle table tw [m]
template <bool INV, typename V>
__device__ __forceinline__ V twiddle(const V* tw, int t, int m) {
  const bool hi = t >= m;
  const V w = tw[hi ? t - m : t];
  return cplx<V>(hi ? -w.x : w.x, hi != INV ? -w.y : w.y);
}

// Copies the twiddle table [m] into shared memory; the caller syncs.
template <typename V>
__device__ __forceinline__ void load_twiddles(V* dst, const V* __restrict__ src, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = src[i];
}

template <typename V>
__device__ __forceinline__ void dft2(V& a, V& b) {
  const V t = a;
  a = cplx<V>(t.x + b.x, t.y + b.y);
  b = cplx<V>(t.x - b.x, t.y - b.y);
}

// in place, natural order: forward X1 = b - i·d, X3 = b + i·d; INV swaps them
template <bool INV, typename V>
__device__ __forceinline__ void dft4(V& x0, V& x1, V& x2, V& x3) {
  const V a = cplx<V>(x0.x + x2.x, x0.y + x2.y), b = cplx<V>(x0.x - x2.x, x0.y - x2.y);
  const V c = cplx<V>(x1.x + x3.x, x1.y + x3.y), d = cplx<V>(x1.x - x3.x, x1.y - x3.y);
  const V bmid = cplx<V>(b.x + d.y, b.y - d.x), bpid = cplx<V>(b.x - d.y, b.y + d.x);
  x0 = cplx<V>(a.x + c.x, a.y + c.y);
  x2 = cplx<V>(a.x - c.x, a.y - c.y);
  x1 = INV ? bpid : bmid;
  x3 = INV ? bmid : bpid;
}

// DFT of R points in registers, o[k] = Σ_n v[n] W_R^{±nk}. R = 8 and 16 are
// R1 x 4 (R1 = 2, 4): n = 4·n1 + n2, k = k1 + R1·k2; DFT_R1 over n1, the
// inner twiddles W_R^{n2·k1}, DFT_4 over n2. m is the FFT's length.
template <int R, bool INV, typename V>
__device__ __forceinline__ void dft(V (&v)[R], V (&o)[R], const V* tw, int m) {
  if constexpr (R == 2) {
    dft2(v[0], v[1]);
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
      if constexpr (R1 == 2) dft2(v[n2], v[4 + n2]);
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
template <int LOG_M, int LOG_NS, bool INV, typename T>
__device__ __forceinline__ void warp_passes(T* re, T* im, const c2<T>* tw, int lane) {
  if constexpr (LOG_NS < LOG_M) {
    using V = c2<T>;
    constexpr int LOG_R = LOG_M - LOG_NS >= 4 ? 4 : LOG_M - LOG_NS;
    constexpr int M = 1 << LOG_M, R = 1 << LOG_R, Q = M >> LOG_R, NS = 1 << LOG_NS;
    constexpr int NB = Q >= 32 ? Q / 32 : 1;            // butterflies per lane
    constexpr int TSTEP = (2 * M) >> (LOG_NS + LOG_R);  // twiddle step, in 1/(2m) turns
    const bool active = Q >= 32 || lane < Q;
    V v[NB][R];
    if (active) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = padded(lane + 32 * b + r * Q);
          v[b][r] = cplx<V>(re[i], im[i]);
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
        V o[R];
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
template <int LOG_M, bool INV, typename T>
__device__ __forceinline__ void warp_fft(T* re, T* im, const c2<T>* tw, int lane) {
  __syncwarp();
  warp_passes<LOG_M, 0, INV>(re, im, tw, lane);
}

// Real-split post-twiddle: bins X[k] and X[m-k] (for k = 0, X[m]) of the
// length-2m real transform whose packed complex FFT Z sits in (zre, zim),
// for 0 <= k <= m/2.
template <typename T>
__device__ __forceinline__ void real_forward(const T* zre, const T* zim, int k, int m, const c2<T>* tw,
                                             c2<T>& xk, c2<T>& xc) {
  using V = c2<T>;
  const T h = 0.5;
  const int kc = (m - k) & (m - 1);
  const V a = cplx<V>(zre[padded(k)], zim[padded(k)]);
  const V b = cplx<V>(zre[padded(kc)], -zim[padded(kc)]);  // conj Z[m-k]
  const V e = cplx<V>(h * (a.x + b.x), h * (a.y + b.y));
  const V o = cplx<V>(h * (a.y - b.y), -h * (a.x - b.x));  // -i (a - b) / 2
  const V wo = cmul(tw[k], o);
  xk = cplx<V>(e.x + wo.x, e.y + wo.y);
  xc = cplx<V>(e.x - wo.x, wo.y - e.y);  // conj(e - wo)
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
