// SwingFilter PLA segmentation (paper §3.1), one thread per stream.
//
// Replaces the TPU kernel src/repro/kernels/swing.py:_swing_kernel.  It
// computes what that kernel computes; it is not carried over block by block.
// The Pallas (stream block, time block) grid with the state in VMEM scratch
// becomes one thread per stream that walks the whole time range in a loop,
// with the state in registers:
//
// - y, brk, a and v are time-major (T, S), so at each t a warp touches 32
//   neighbouring streams in one coalesced transaction;
// - the packed carry (6, S) f32 (rows: 0 started, 1 od, 2 oy, 3 slo, 4 shi,
//   5 run_len) is read at the start and written at the end, so a launch
//   resumes exactly where the previous one stopped;
// - eps is a per-stream vector (S,); t_real < 0 disables the forced break.
//
// Event semantics: processing local time t may decide that the segment ended
// at t-1; the event is written at row t.  A forced break at t == t_real
// closes the trailing run through the same path.
//
// Bound on this card: each point moves 13 bytes (y 4 in; brk 1, a 4, v 4
// out).  At 4096 streams x 20000 points that is 1.07 GB, 0.32 ms at
// 3.35 TB/s; the ~30 f32 operations a point are far below the f32 peak.  But
// the time loop is a serial dependence through the carried state, and a few
// thousand streams put about one warp on each of the 132 SMs, so the chain
// of dependent operations per step, not bandwidth, is expected to set the
// pace.
//
// Floating point: built with -fmad=false, so no a*b+c is contracted, except
// at the one site where XLA:CPU contracts the JAX reference
// (jax_pla.py:286, kernels/swing.py:73), written as __fmaf_rn.  Division is
// IEEE (the nvcc default).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 32;

__global__ void swing_kernel(const float* __restrict__ y,
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
  float od = cin[S + s];
  float oy = cin[2 * S + s];
  float slo = cin[3 * S + s];
  float shi = cin[4 * S + s];
  int run_len = static_cast<int>(cin[5 * S + s]);

#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const size_t i = static_cast<size_t>(t) * S + s;
    const float yt = y[i];
    const bool is_first = !started;

    const float dts = od == 0.0f ? 1.0f : od;
    const float n1 = (yt - e - oy) / dts;
    const float n2 = (yt + e - oy) / dts;
    const float t_slo = fmaxf(slo, fminf(n1, n2));
    const float t_shi = fminf(shi, fmaxf(n1, n2));
    const bool feasible = t_slo <= t_shi;
    const bool brk =
        (!feasible || run_len >= max_run || t == t_real) && !is_first;

    const float a = 0.5f * (slo + shi);
    const float v = __fmaf_rn(a, od - 1.0f, oy);  // knot at t-1, old line
    brk_out[i] = brk ? 1 : 0;
    a_out[i] = brk ? a : 0.0f;
    v_out[i] = brk ? v : 0.0f;

    // Restart from the knot (t-1, v); re-add this point (distance 1).
    const float b_lo = yt - e - v;
    const float b_hi = yt + e - v;
    od = is_first ? 1.0f : (brk ? 2.0f : od + 1.0f);
    oy = brk ? v : (is_first ? yt : oy);
    slo = brk ? fminf(b_lo, b_hi) : (is_first ? -kBig : t_slo);
    shi = brk ? fmaxf(b_lo, b_hi) : (is_first ? kBig : t_shi);
    run_len = (brk || is_first) ? 1 : run_len + 1;
    started = true;
  }

  cout[s] = started ? 1.0f : 0.0f;
  cout[S + s] = od;
  cout[2 * S + s] = oy;
  cout[3 * S + s] = slo;
  cout[4 * S + s] = shi;
  cout[5 * S + s] = static_cast<float>(run_len);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int swing_launch(const float* y, const float* eps, const float* cin,
                            int8_t* brk, float* a, float* v, float* cout,
                            int T, int S, int max_run, int t_real,
                            cudaStream_t stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  swing_kernel<<<blocks, kThreads, 0, stream>>>(y, eps, cin, brk, a, v, cout,
                                                T, S, max_run, t_real);
  return static_cast<int>(cudaGetLastError());
}
