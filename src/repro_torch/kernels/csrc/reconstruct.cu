// Segment events -> dense stream reconstruction, one thread per stream.
//
// Replaces the two TPU kernels of src/repro/kernels/reconstruct.py:
// _recon_kernel (recon_launch) and _recon_err_kernel (recon_err_launch).
// Each point takes the line of the segment that ends at the next break
// at-or-after it, so the walk runs backward in time: one thread per stream
// loops t = T-1 .. 0 with the anchored line (ca slope, cv value at the
// anchor, cd distance to the anchor) in registers, and y' = cv - ca * cd.
// The packed carry (3, S) f32 (rows 0 ca, 1 cv, 2 cd) is read at the start
// and written at the end; it propagates backward, so a chunked walk launches
// the latest slab first and hands its carry to the slab before it.  brk is
// int8, everything else f32, all time-major (T, S) so a warp reads 32
// neighbouring streams per step.
//
// Bound on this card: recon moves 13 bytes a point (brk 1, a 4, v 4 in; out
// 4), recon_err 21 (plus y 4 in and err 4 out): 1.07 GB and 1.72 GB, 0.32 ms
// and 0.51 ms at 3.35 TB/s for 4096 x 20000 points.  The backward walk is a
// serial dependence through (ca, cv, cd); with about one warp per SM at a few
// thousand streams the per-step latency, not bandwidth, is expected to set
// the pace.  (A parallel next-break scan would remove the chain; that is for
// a later change.)
//
// Floating point: built with -fmad=false; cv - ca * cd is written as
// __fmaf_rn(-ca, cd, cv), the contraction XLA:CPU makes in the JAX reference
// (jax_pla.py:2082, kernels/reconstruct.py:60 and :97).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <bool kWithError>
__global__ void recon_kernel(const int8_t* __restrict__ brk,
                             const float* __restrict__ a,
                             const float* __restrict__ v,
                             const float* __restrict__ y,
                             const float* __restrict__ cin,
                             float* __restrict__ out,
                             float* __restrict__ err,
                             float* __restrict__ cout, int T, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float ca = cin[s];
  float cv = cin[S + s];
  float cd = cin[2 * S + s];

#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * S + s;
    if (brk[i] != 0) {
      ca = a[i];
      cv = v[i];
      cd = 0.0f;
    }
    const float r = __fmaf_rn(-ca, cd, cv);
    out[i] = r;
    if (kWithError) err[i] = fabsf(r - y[i]);
    cd = cd + 1.0f;
  }

  cout[s] = ca;
  cout[S + s] = cv;
  cout[2 * S + s] = cd;
}

int launch(bool with_error, const int8_t* brk, const float* a, const float* v,
           const float* y, const float* cin, float* out, float* err,
           float* cout, int T, int S, cudaStream_t stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  if (with_error) {
    recon_kernel<true><<<blocks, kThreads, 0, stream>>>(brk, a, v, y, cin, out,
                                                        err, cout, T, S);
  } else {
    recon_kernel<false><<<blocks, kThreads, 0, stream>>>(brk, a, v, y, cin,
                                                         out, err, cout, T, S);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError().
extern "C" int recon_launch(const int8_t* brk, const float* a, const float* v,
                            const float* cin, float* out, float* cout, int T,
                            int S, cudaStream_t stream) {
  return launch(false, brk, a, v, nullptr, cin, out, nullptr, cout, T, S,
                stream);
}

extern "C" int recon_err_launch(const int8_t* brk, const float* a,
                                const float* v, const float* y,
                                const float* cin, float* out, float* err,
                                float* cout, int T, int S,
                                cudaStream_t stream) {
  return launch(true, brk, a, v, y, cin, out, err, cout, T, S, stream);
}
