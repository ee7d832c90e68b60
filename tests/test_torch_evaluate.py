"""Port ``evaluate_batched`` (Sw, A1, A2, A3) against the JAX reference.

The slice as a whole: GPS-surrogate streams from one seeded generator go
through ``repro.core.evaluate.evaluate_batched`` and the port's, on the
CPU.  With ``reconstruct="lines"`` every metric array, byte count and
pooled summary is equal; with ``reconstruct="kernel"`` the error equals
``|propagate_lines - y|`` of the reference, masked to segment points.
Tolerance: exact equality.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_pla
from repro.core import protocol_engine as ref_engine
from repro.data import synthetic as ref_synthetic
from repro_torch.core import evaluate
from repro_torch.core.evaluate import (BATCHED_SEGMENTERS, COMBINATIONS,
                                       PROTOCOL_CAPS, evaluate_batched)
from repro_torch.data import synthetic

# The module, not the ``repro.core.evaluate`` function that shadows it.
ref_eval = importlib.import_module("repro.core.evaluate")

SLICE = ("Sw", "A1", "A2", "A3")


def _gps(seed=0, S=3, T=500):
    return synthetic.make_batch("gps", S, T, np.random.default_rng(seed),
                                device="cpu").numpy()


@pytest.mark.parametrize("name", synthetic.DATASETS)
def test_generators_match_reference(name):
    """The copied generators draw the same values from the same rng."""
    ts, ys = synthetic._GENS[name](np.random.default_rng(3), 700)
    ts_r, ys_r = ref_synthetic._GENS[name](np.random.default_rng(3), 700)
    np.testing.assert_array_equal(ts, ts_r)
    np.testing.assert_array_equal(ys, ys_r)
    assert synthetic.EPS_GRID == ref_synthetic.EPS_GRID
    for spec in ("p0.5", "p5", "p5C", "2.5"):
        assert synthetic.ucr_eps(ys, spec) == ref_synthetic.ucr_eps(ys, spec)


def test_make_batch_is_seeded_and_float32():
    a = synthetic.make_batch("gps", 2, 300, np.random.default_rng(1),
                             device="cpu")
    b = synthetic.make_batch("gps", 2, 300, np.random.default_rng(1),
                             device="cpu")
    assert a.dtype == torch.float32 and a.shape == (2, 300)
    assert torch.equal(a, b)
    rng = np.random.default_rng(1)
    first = ref_synthetic._gps(rng, 300)[1].astype(np.float32)
    np.testing.assert_array_equal(a[0].numpy(), first)


def test_tables_match_reference():
    assert COMBINATIONS == ref_eval.COMBINATIONS
    assert evaluate.METHOD_KNOT_KINDS == ref_eval.METHOD_KNOT_KINDS
    from repro.core.protocols import PROTOCOL_CAPS as ref_caps
    assert PROTOCOL_CAPS == ref_caps
    assert sorted(BATCHED_SEGMENTERS) == ["angle", "swing"]
    # One table: the evaluator's segmenters are the kernel-backed ones.
    from repro_torch.kernels import ops
    assert BATCHED_SEGMENTERS is ops.KERNEL_SEGMENTERS
    assert ops.KERNEL_SEGMENTERS == {"swing": ops.swing_segment_cuda,
                                     "angle": ops.angle_segment_cuda}


@pytest.mark.parametrize("key", SLICE)
@pytest.mark.parametrize("per_stream", [False, True])
def test_lines_path_identical_to_reference(key, per_stream):
    method, proto = COMBINATIONS[key]
    y = _gps(seed=11)
    eps = (np.asarray([1.0, 10.0, 50.0], np.float32) if per_stream
           else 10.0)
    want = ref_eval.evaluate_batched(method, proto, y, eps)
    got = evaluate_batched(method, proto, y, eps, device="cpu")
    for name in ("ratio", "latency", "error"):
        np.testing.assert_array_equal(getattr(got.metrics, name).numpy(),
                                      getattr(want.metrics, name))
    np.testing.assert_array_equal(got.overall_ratio, want.overall_ratio)
    np.testing.assert_array_equal(got.n_records, want.n_records)
    np.testing.assert_array_equal(got.eps, want.eps)
    assert got.metrics.pooled_summary() == want.metrics.pooled_summary()
    g, w = got.summary(), want.summary()
    for name in ("ratio", "latency", "error"):
        for stat in w[name]:
            np.testing.assert_array_equal(g[name][stat], w[name][stat])


@pytest.mark.parametrize("key", SLICE)
def test_kernel_error_path_equals_reference_walk(key):
    """``reconstruct="kernel"``: the fused walk's error equals the
    reference's ``|propagate_lines - y|`` on segment points, 0 elsewhere."""
    method, proto = COMBINATIONS[key]
    y = _gps(seed=12)
    got = evaluate_batched(method, proto, y, 10.0, reconstruct="kernel",
                           device="cpu")
    cap = PROTOCOL_CAPS[proto] or 256
    seg = getattr(jax_pla, f"{method}_segment")(jnp.asarray(y), 10.0,
                                                 max_run=cap)
    err = np.abs(np.asarray(jax_pla.propagate_lines(seg)) - y)
    kind = evaluate.METHOD_KNOT_KINDS.get(method, "disjoint")
    d = ref_engine.protocol_descriptors(seg, proto, kind)
    want = np.where(np.asarray(d.kind) == ref_engine.KIND_SEGMENT,
                    err.astype(np.float64), 0.0)
    np.testing.assert_array_equal(got.metrics.error.numpy(), want)
    lines = evaluate_batched(method, proto, y, 10.0, device="cpu")
    for name in ("ratio", "latency"):
        assert torch.equal(getattr(got.metrics, name),
                           getattr(lines.metrics, name))


def test_counter_cap_guard_and_unported_methods():
    y = _gps(S=2, T=64)
    with pytest.raises(ValueError, match="counter cap"):
        evaluate_batched("angle", "singlestreamv", y, 1.0, max_run=256,
                         device="cpu")
    with pytest.raises(ValueError, match="counter cap"):
        evaluate_batched("angle", "singlestream", y, 1.0, max_run=300,
                         device="cpu")
    for method in ("nope", "disjoint", "mixed"):
        with pytest.raises(ValueError, match="no batched segmenter"):
            evaluate_batched(method, "implicit", y, 1.0, device="cpu")
    with pytest.raises(ValueError, match="reconstruct"):
        evaluate_batched("angle", "implicit", y, 1.0, reconstruct="pallas",
                         device="cpu")
    # cap == max_run is legal; implicit is uncapped (engine default 256)
    evaluate_batched("angle", "singlestreamv", y, 1.0, max_run=127,
                     device="cpu")
    r = evaluate_batched("swing", "implicit", y, 1.0, max_run=512,
                         device="cpu")
    assert r.n_records.min() >= 1



@pytest.mark.parametrize("key", ["Sw", "A1"])
def test_eps_check_slack_below_float32_ulp_raises_like_reference(key):
    """At |y| ~ 2e5 one float32 ulp (0.0156) exceeds the check's absolute
    slack ε·1e-4 + 1e-5 at ε = 1, so the reference's check_eps raises on
    streams it segmented correctly in float32; the port keeps that check
    as it is and raises the same error.  Within two ulps of |y| + ε the
    guarantee holds."""
    method, proto = COMBINATIONS[key]
    y = (2e5 + _gps(seed=13, S=4, T=600)).astype(np.float32)
    with pytest.raises(ValueError) as want:
        ref_eval.evaluate_batched(method, proto, y, 1.0)
    with pytest.raises(ValueError) as got:
        evaluate_batched(method, proto, y, 1.0, device="cpu")
    assert str(got.value) == str(want.value)
    assert "max-error guarantee violated" in str(got.value)
    r = evaluate_batched(method, proto, y, 1.0, check_eps=False,
                         device="cpu")
    ulp = np.spacing(np.abs(y) + np.float32(1.0)).astype(np.float64)
    assert (r.metrics.error.numpy() - (1 + 1e-4) - 1e-5 <= 2 * ulp).all()
