#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with one CUDA card.  The script
imports only ``repro_torch`` (never ``jax`` or the JAX package ``repro``)
and fails, printing no result, without CUDA or without the repository
around it.  Phases:

1. identify the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at
   4096 x 2048 points of the GPS surrogate (offline, and chunked at
   1000/1048; Angle at ``max_run`` 256 and at SingleStreamV's cap of 127),
   and the whole pipeline on the card against the CPU (plain versions) on
   a small batch;
4. the main path at full size: 4096 GPS-surrogate streams x 20 000 points
   (``paper_eval``'s per-trace length), Sw/A1/A2/A3 at each ε of the GPS
   grid through ``evaluate_batched(reconstruct="kernel")`` with the ε
   guarantee held to float32 rounding (see below), the wire bytes at
   ε = 10 checked against ``protocol_nbytes`` and the streams rebuilt from
   their segment records as a receiver does, and A2 pushed through
   ``step_chunk``/``flush`` in 1000-point chunks;
5. the launch counts of that run (every kernel must have launched), then
   each kernel's time, its plain version's time and its bound at the
   main-path shapes, as one JSON line (Angle also held against its plain
   version there at ``max_run`` 127, as A3 runs it);
6. the last line, ``{"ok": true, "device": {...}}``.

Every failure raises, so the exit code is nonzero and the last line is
missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

SLICE = ("Sw", "A1", "A2", "A3")
# The main path: 4096 GPS-surrogate streams x 20 000 points each
# (``paper_eval``'s per-trace length).  The kernel-against-plain phase uses
# the first TC points: the plain versions loop over time in Python.
STREAMS, POINTS, TC = 4096, 20000, 2048


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events), after one warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(kernel_out, plain_out) -> float:
    """Largest |kernel - plain| over the outputs; raises unless equal."""
    import torch
    worst = 0.0
    for k, p in zip(kernel_out, plain_out):
        check(k.shape == p.shape and k.dtype == p.dtype,
              f"shape/dtype differ: {k.shape} {k.dtype} vs {p.shape} "
              f"{p.dtype}")
        worst = max(worst, float((k.double() - p.double()).abs().max()))
        check(torch.equal(k, p), f"kernel and plain version differ (max "
                                 f"|diff| {worst})")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from repro_torch.core import evaluate, pla
    from repro_torch.core.evaluate import COMBINATIONS, evaluate_batched
    from repro_torch.core.protocol_engine import (batched_point_metrics,
                                                  encode_batch,
                                                  protocol_nbytes)
    from repro_torch.data.synthetic import EPS_GRID, make_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.angle import (angle_init_carry, angle_plain,
                                           launch_angle)
    from repro_torch.kernels.common import LAUNCHES, pad_streams, \
        reset_launches
    from repro_torch.kernels.ops import (reconstruct_error_cuda,
                                         reconstruct_records_cuda)
    from repro_torch.kernels.reconstruct import (launch_recon,
                                                 launch_recon_err,
                                                 recon_err_plain,
                                                 recon_init_carry,
                                                 recon_plain)
    from repro_torch.kernels.swing import (launch_swing, swing_init_carry,
                                           swing_plain)

    dev = torch.device("cuda")
    S, T, Tc = STREAMS, POINTS, TC
    a3_cap = evaluate.PROTOCOL_CAPS["singlestreamv"]

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    print(f"[card] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. Build every kernel, one nvcc per source, in parallel.
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(libs)}",
          flush=True)
    for stem, (_, log) in sorted(libs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {stem}] {line.strip()}")

    t0 = time.perf_counter()
    y = make_batch("gps", S, T, np.random.default_rng(args.seed), device=dev)
    torch.cuda.synchronize()
    print(f"[data] gps {S} x {T} float32 ({y.numel() * 4 / 1e6:.0f} MB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    errs = {"swing": 0.0, "angle": 0.0, "recon": 0.0, "recon_err": 0.0}

    # 3a. Each kernel against its plain version on the same inputs.
    eps10 = torch.full((S,), 10.0, device=dev)
    y_c = pad_streams(y[:, :Tc])                    # (Tc + 1, S)
    events = {}
    for name, launch, plain, init, max_run in (
            ("swing", launch_swing, swing_plain, swing_init_carry, 256),
            ("angle", launch_angle, angle_plain, angle_init_carry, a3_cap),
            ("angle", launch_angle, angle_plain, angle_init_carry, 256)):
        kw = dict(max_run=max_run)
        off = launch(y_c, eps10, init(S, dev), t_real=Tc, **kw)
        errs[name] = max(errs[name], max_abs_err(
            off, plain(y_c, eps10, init(S, dev), t_real=Tc, **kw)))
        c1 = launch(y_c[:1000].contiguous(), eps10, init(S, dev), t_real=-1,
                    **kw)
        errs[name] = max(errs[name], max_abs_err(
            c1, plain(y_c[:1000], eps10, init(S, dev), t_real=-1, **kw)))
        c2 = launch(y_c[1000:].contiguous(), eps10, c1[3], t_real=Tc - 1000,
                    **kw)
        errs[name] = max(errs[name], max_abs_err(
            c2, plain(y_c[1000:], eps10, c1[3], t_real=Tc - 1000, **kw)))
        for whole, a, b in zip(off[:3], c1[:3], c2[:3]):
            check(torch.equal(whole, torch.cat([a, b])),
                  f"{name}: chunked 1000/1048 differs from offline")
        events[name] = [x[1:Tc + 1].contiguous() for x in off[:3]]
        print(f"[kernel=plain] {name} max_run {max_run} {S}x{Tc}: offline "
              f"and chunked 1000/1048 equal", flush=True)
    brk_t, a_t, v_t = events["angle"]
    yc_t = y_c[:Tc]
    zero = recon_init_carry(S, dev)
    for name, launch, plain, extra in (
            ("recon", launch_recon, recon_plain, ()),
            ("recon_err", launch_recon_err, recon_err_plain, (yc_t,))):
        whole = launch(brk_t, a_t, v_t, *extra, zero)
        errs[name] = max(errs[name], max_abs_err(
            whole, plain(brk_t, a_t, v_t, *extra, zero)))
        late = launch(brk_t[1048:], a_t[1048:], v_t[1048:],
                      *(x[1048:] for x in extra), zero)
        early = launch(brk_t[:1048], a_t[:1048], v_t[:1048],
                       *(x[:1048] for x in extra), late[-1])
        for w, e, l in zip(whole[:-1], early[:-1], late[:-1]):
            check(torch.equal(w, torch.cat([e, l])),
                  f"{name}: suffix-first 1048/1000 differs from one shot")
        print(f"[kernel=plain] {name} {S}x{Tc}: one shot and suffix-first "
              f"equal", flush=True)

    # 3b. The pipeline on the card against the CPU on a small batch.
    y_small = y[:64, :1500]
    for key in SLICE:
        method, proto = COMBINATIONS[key]
        for recon in ("lines", "kernel"):
            g = evaluate_batched(method, proto, y_small, 10.0,
                                 reconstruct=recon, check_eps=False,
                                 device=dev)
            c = evaluate_batched(method, proto, y_small.cpu(), 10.0,
                                 reconstruct=recon, check_eps=False,
                                 device="cpu")
            for m in ("ratio", "latency", "error"):
                check(torch.equal(getattr(g.metrics, m).cpu(),
                                  getattr(c.metrics, m)),
                      f"{key}/{recon}: {m} differs between card and CPU")
            check(np.array_equal(g.overall_ratio, c.overall_ratio)
                  and np.array_equal(g.n_records, c.n_records),
                  f"{key}/{recon}: byte counts differ between card and CPU")
    print("[card=cpu] Sw A1 A2 A3 on 64 x 1500: metrics and bytes equal",
          flush=True)

    # 4. The main path at full size; launches counted from here.
    reset_launches()
    t_main = time.perf_counter()
    results = {}
    for eps in EPS_GRID["gps"]:
        # The ε guarantee in float32: |y' - y| <= ε(1 + 1e-4) + 1e-5 plus
        # two float32 ulps of |y| + ε.  evaluate_batched's own check_eps
        # (the reference's absolute 1e-5 slack) is below one ulp of the
        # GPS surrogate's values at 20 000 points (|y| up to ~5e4), and
        # raises there on the JAX reference as on the port, so the smoke
        # holds the guarantee here, with the ulp term made explicit.
        mag = y.abs() + eps
        ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
               - mag).double()
        del mag
        for key in SLICE:
            method, proto = COMBINATIONS[key]
            t0 = time.perf_counter()
            r = evaluate_batched(method, proto, y, eps, reconstruct="kernel",
                                 check_eps=False, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for m in ("ratio", "latency", "error"):
                x = getattr(r.metrics, m)
                check(tuple(x.shape) == (S, T) and bool(x.isfinite().all()),
                      f"{key} eps={eps}: {m} not finite of shape {(S, T)}")
            excess = r.metrics.error - (eps * (1 + 1e-4) + 1e-5)
            past = int((excess > 0).sum())
            worst = float((excess / ulp).max())
            check(worst <= 2.0, f"{key} eps={eps}: ε guarantee broken, "
                                f"{worst} float32 ulps past ε")
            del excess
            t0 = time.perf_counter()
            pooled = r.metrics.pooled_summary()
            summary_s = time.perf_counter() - t0
            results[(eps, key)] = pooled
            print(f"[main] eps={eps:g} {key}: ratio "
                  f"{pooled['ratio']['mean']!r} latency "
                  f"{pooled['latency']['mean']!r} error "
                  f"{pooled['error']['mean']!r} overall_ratio "
                  f"{float(np.mean(r.overall_ratio))!r}; max error "
                  f"{pooled['error']['max']!r}, {past} points past "
                  f"ε(1+1e-4)+1e-5, worst {max(worst, 0.0):.2f} ulp past; "
                  f"evaluate_batched {wall:.3f} s, host summary "
                  f"{summary_s:.1f} s", flush=True)
        del ulp
    eps = 10.0
    for key in SLICE:
        method, proto = COMBINATIONS[key]
        kind = evaluate.METHOD_KNOT_KINDS.get(method, "disjoint")
        cap = evaluate.PROTOCOL_CAPS[proto] or 256
        seg = evaluate.BATCHED_SEGMENTERS[method](y, eps, max_run=cap)
        nbytes, _ = protocol_nbytes(seg, proto, kind)
        blobs = encode_batch(seg, y, proto, kind)
        sizes = np.array([len(b[0]) + len(b[1]) if proto == "twostreams"
                          else len(b) for b in blobs])
        want = nbytes.cpu().numpy() + (16 if proto == "implicit" else 0)
        check(np.array_equal(sizes, want),
              f"{key}: wire bytes differ from protocol_nbytes")
        # The receiver's side: the stream rebuilt from its segment records
        # by the reverse-walk kernel equals the fused walk's reconstruction.
        k_max = int(seg.breaks.sum(dim=1).max())
        rec = pla.to_records(seg, k_max)
        check(not bool(rec.overflow.any()), f"{key}: records overflowed")
        y_rx = reconstruct_records_cuda(rec, T)
        check(torch.equal(y_rx, reconstruct_error_cuda(seg, y)[0]),
              f"{key}: records reconstruction differs from the fused walk")
        print(f"[wire] eps=10 {key}: {int(sizes.sum())} bytes = "
              f"protocol_nbytes{' + 16 B/stream' if proto == 'implicit' else ''}"
              f"; {int(rec.count.sum())} records rebuild the streams",
              flush=True)
    state = pla.init_state("angle", S, eps, max_run=256, device=dev)
    parts = []
    for lo in range(0, T, 1000):
        state, out = pla.step_chunk(state, y[:, lo:lo + 1000])
        parts.append(out)
    state, out = pla.flush(state)
    parts.append(out)
    offline = pla.angle_segment(y, eps, max_run=256)
    for whole, *chunks in zip(offline, *parts):
        check(torch.equal(whole, torch.cat(chunks, dim=1)),
              "A2 chunked through step_chunk/flush differs from offline")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"[main] {time.perf_counter() - t_main:.1f} s; A2 in 1000-point "
          f"chunks equals offline; launches {json.dumps(launches)}",
          flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    # 5. Where the main path's time goes, per combination (CUDA events).
    for eps in EPS_GRID["gps"]:
        for key in SLICE:
            method, proto = COMBINATIONS[key]
            kind = evaluate.METHOD_KNOT_KINDS.get(method, "disjoint")
            cap = evaluate.PROTOCOL_CAPS[proto] or 256
            segment = evaluate.BATCHED_SEGMENTERS[method]
            seg = segment(y, eps, max_run=cap)
            seg_ms = cuda_ms(lambda: segment(y, eps, max_run=cap), 2)
            err_ms = cuda_ms(lambda: reconstruct_error_cuda(seg, y), 2)
            abs_err = reconstruct_error_cuda(seg, y)[1]
            met_ms = cuda_ms(lambda: (batched_point_metrics(
                seg, y, proto, kind, abs_err=abs_err),
                protocol_nbytes(seg, proto, kind)), 2)
            print(f"[ms] eps={eps:g} {key}: segment {seg_ms:.3f} "
                  f"reconstruct-error {err_ms:.3f} metrics {met_ms:.3f}",
                  flush=True)

    # Each kernel at the main-path shapes: its time, its plain version's
    # time (one run, also compared in full), and its bound.
    y_t = pad_streams(y)                             # (T + 1, S)
    eps10 = torch.full((S,), 10.0, device=dev)
    seg_args = {n: (y_t, eps10, init(S, dev)) for n, init in
                (("swing", swing_init_carry), ("angle", angle_init_carry))}
    ang = launch_angle(*seg_args["angle"], max_run=256, t_real=T)
    brk_t, a_t, v_t = (x[1:].contiguous() for x in ang[:3])
    yt = y_t[:T]
    zero = recon_init_carry(S, dev)
    work = {  # name: (kernel call, plain call, bytes, f32 operations)
        "swing": (lambda: launch_swing(*seg_args["swing"], max_run=256,
                                       t_real=T),
                  lambda: swing_plain(*seg_args["swing"], max_run=256,
                                      t_real=T),
                  y_t.numel() * 13, y_t.numel() * 22),
        "angle": (lambda: launch_angle(*seg_args["angle"], max_run=256,
                                       t_real=T),
                  lambda: angle_plain(*seg_args["angle"], max_run=256,
                                      t_real=T),
                  y_t.numel() * 13, y_t.numel() * 35),
        "recon": (lambda: launch_recon(brk_t, a_t, v_t, zero),
                  lambda: recon_plain(brk_t, a_t, v_t, zero),
                  a_t.numel() * 13, a_t.numel() * 3),
        "recon_err": (lambda: launch_recon_err(brk_t, a_t, v_t, yt, zero),
                      lambda: recon_err_plain(brk_t, a_t, v_t, yt, zero),
                      a_t.numel() * 21, a_t.numel() * 5),
    }
    meta = {
        "swing": ("csrc/swing.cu", "src/repro/kernels/swing.py:38"),
        "angle": ("csrc/angle.cu", "src/repro/kernels/angle.py:49"),
        "recon": ("csrc/reconstruct.cu",
                  "src/repro/kernels/reconstruct.py:36"),
        "recon_err": ("csrc/reconstruct.cu",
                      "src/repro/kernels/reconstruct.py:72"),
    }
    # A3 runs Angle at SingleStreamV's cap: hold that at full size too.
    kw = dict(max_run=a3_cap, t_real=T)
    errs["angle"] = max(errs["angle"], max_abs_err(
        launch_angle(*seg_args["angle"], **kw),
        angle_plain(*seg_args["angle"], **kw)))
    print(f"[kernel=plain] angle max_run {a3_cap} {S}x{T}: equal",
          flush=True)
    rows, serial = [], {}
    for name, (kernel, plain, nbytes, nops) in work.items():
        ms = cuda_ms(kernel, 5)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        p_out = plain()
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        errs[name] = max(errs[name], max_abs_err(kernel(), p_out))
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       nops / PEAK_F32_PER_S) * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/{meta[name][0]}",
                     "replaces": meta[name][1], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                                  >= nops / PEAK_F32_PER_S
                                  else "operations"),
                     "library_ms": None})
        print(f"[kernel] {name}: {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.3f} ms", flush=True)
    # Per-step latency: one warp of (up to) 32 streams walking T steps alone.
    w = min(32, S)
    y32_t = pad_streams(y[:w])
    c32 = {"swing": swing_init_carry(w, dev),
           "angle": angle_init_carry(w, dev)}
    e32 = eps10[:w].contiguous()
    ev32 = [x[:, :w].contiguous() for x in (brk_t, a_t, v_t)]
    z32 = recon_init_carry(w, dev)
    one = {
        "swing": lambda: launch_swing(y32_t, e32, c32["swing"], max_run=256,
                                      t_real=T),
        "angle": lambda: launch_angle(y32_t, e32, c32["angle"], max_run=256,
                                      t_real=T),
        "recon": lambda: launch_recon(*ev32, z32),
        "recon_err": lambda: launch_recon_err(*ev32, y32_t[:T].contiguous(),
                                              z32),
    }
    for name, fn in one.items():
        serial[name] = cuda_ms(fn, 3) * 1e6 / T   # ns per step
    print(json.dumps({f"serial_ns_per_step_{w}_streams": serial,
                      "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
