// Angle PLA segmentation (paper §3.1), one thread per stream.
//
// Replaces the TPU kernel src/repro/kernels/angle.py:_angle_kernel.  The
// wedge origin is the crossing of the extreme lines through the first two
// error segments; the state is the origin (as an offset from the current
// step) plus the feasible slope interval.  The translation is the one of
// swing.cu: one thread per stream walks the whole time range with the state
// in registers, y/brk/a/v are time-major (T, S) so a warp reads 32
// neighbouring streams per step, and the packed carry (8, S) f32 (rows:
// 0 started, 1 phase, 2 p0y, 3 od, 4 oy, 5 slo, 6 shi, 7 run_len) is read at
// the start and written at the end.  eps is a per-stream vector (S,);
// t_real < 0 disables the forced break.
//
// Bound on this card: 13 bytes a point (y 4 in; brk 1, a 4, v 4 out), 1.07 GB
// and 0.32 ms at 3.35 TB/s for 4096 x 20000 points.  As for Swing, the
// serial dependence of the time loop through the state, with about one warp
// per SM at a few thousand streams, is expected to set the pace, not
// bandwidth.
//
// Floating point: built with -fmad=false; __fmaf_rn is written at exactly the
// two sites where XLA:CPU contracts the JAX reference: v_out (jax_pla.py:234,
// kernels/angle.py:96) and the new origin value (jax_pla.py:216,
// kernels/angle.py:79).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 32;

__global__ void angle_kernel(const float* __restrict__ y,
                             const float* __restrict__ eps,
                             const float* __restrict__ cin,
                             int8_t* __restrict__ brk_out,
                             float* __restrict__ a_out,
                             float* __restrict__ v_out,
                             float* __restrict__ cout,
                             int T, int S, int max_run, int t_real) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float e = eps[s];
  bool started = cin[s] != 0.0f;
  int phase = static_cast<int>(cin[S + s]);
  float p0y = cin[2 * S + s];
  float od = cin[3 * S + s];
  float oy = cin[4 * S + s];
  float slo = cin[5 * S + s];
  float shi = cin[6 * S + s];
  int run_len = static_cast<int>(cin[7 * S + s]);

#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const size_t i = static_cast<size_t>(t) * S + s;
    const float yt = y[i];
    const bool is_first = !started;

    // Phase 0 -> 1: origin from p0 (offset 0) and this point (offset 1).
    const float amax = (yt + e) - (p0y - e);
    const float amin = (yt - e) - (p0y + e);
    const float da = amax - amin;
    const bool flat = fabsf(da) < 1e-30f;
    const float das = flat ? 1.0f : da;
    const float ox_rel = flat ? 0.5f : 2.0f * e / das;
    const float oy_new = __fmaf_rn(amax, ox_rel, p0y - e);
    const float od_new0 = 1.0f - ox_rel;

    // Phase 1: wedge update; the origin sits od steps behind t.
    const float dts = od == 0.0f ? 1.0f : od;
    const float n1 = (yt - e - oy) / dts;
    const float n2 = (yt + e - oy) / dts;
    const float t_slo = fmaxf(slo, fminf(n1, n2));
    const float t_shi = fminf(shi, fmaxf(n1, n2));
    const bool feasible = t_slo <= t_shi;
    const bool brk =
        ((phase == 1 && (!feasible || run_len >= max_run)) || t == t_real) &&
        !is_first;

    const float a = phase == 1 ? 0.5f * (slo + shi) : 0.0f;
    const float v = phase == 1 ? __fmaf_rn(a, od - 1.0f, oy) : p0y;
    brk_out[i] = brk ? 1 : 0;
    a_out[i] = brk ? a : 0.0f;
    v_out[i] = brk ? v : 0.0f;

    // Commit the next state.
    const bool restart = brk || is_first;
    const bool go0 = phase == 0 && !brk && !is_first;  // origin just built
    phase = restart ? 0 : 1;
    p0y = restart ? yt : p0y;
    od = go0 ? od_new0 + 1.0f : (restart ? 0.0f : od + 1.0f);
    oy = go0 ? oy_new : oy;
    slo = go0 ? amin : (brk ? -kBig : t_slo);
    shi = go0 ? amax : (brk ? kBig : t_shi);
    run_len = restart ? 1 : run_len + 1;
    started = true;
  }

  cout[s] = started ? 1.0f : 0.0f;
  cout[S + s] = static_cast<float>(phase);
  cout[2 * S + s] = p0y;
  cout[3 * S + s] = od;
  cout[4 * S + s] = oy;
  cout[5 * S + s] = slo;
  cout[6 * S + s] = shi;
  cout[7 * S + s] = static_cast<float>(run_len);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int angle_launch(const float* y, const float* eps, const float* cin,
                            int8_t* brk, float* a, float* v, float* cout,
                            int T, int S, int max_run, int t_real,
                            cudaStream_t stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  angle_kernel<<<blocks, kThreads, 0, stream>>>(y, eps, cin, brk, a, v, cout,
                                                T, S, max_run, t_real);
  return static_cast<int>(cudaGetLastError());
}
