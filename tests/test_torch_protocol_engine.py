"""Port protocol engine against the JAX reference on the same segmentation.

One reference ``SegmentOutput`` feeds both engines.  For the four §5
protocols and the ``joint`` / ``disjoint`` knot kinds, every descriptor
field, the byte counts, the float32 device metrics, the float64 metrics
and the wire bytes must be equal.  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_pla
from repro.core import protocol_engine as ref_engine
from repro_torch.core import convert
from repro_torch.core import protocol_engine as engine

PROTOCOLS = ("implicit", "twostreams", "singlestream", "singlestreamv")
KINDS = ("joint", "disjoint")


def _case(method="angle", seed=0, S=5, T=400, max_run=127, noise=25.0):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(0, 0.6, (S, T)), axis=1).astype(np.float32)
    y[-1] = rng.normal(0, noise, T)   # noisy rows: singletons and bursts
    y[-2, 100:] = rng.normal(0, noise, T - 100)
    ref = getattr(jax_pla, f"{method}_segment")(jnp.asarray(y), 1.0,
                                                 max_run=max_run)
    return y, ref, convert.segment_output_from_reference(*ref, device="cpu")


def _equal(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


@pytest.mark.parametrize("knot_kind", KINDS)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_descriptors_and_nbytes_match(protocol, knot_kind):
    _, ref, seg = _case(seed=1)
    d_ref = ref_engine.protocol_descriptors(ref, protocol, knot_kind)
    d = engine.protocol_descriptors(seg, protocol, knot_kind)
    for name in d._fields:
        _equal(getattr(d, name), getattr(d_ref, name))
        assert getattr(d, name).dtype == {
            "head": torch.bool, "a": torch.float32,
            "v": torch.float32}.get(name, torch.int32), name
    for got, want in zip(engine.protocol_nbytes(seg, protocol, knot_kind),
                         ref_engine.protocol_nbytes(ref, protocol,
                                                    knot_kind)):
        _equal(got, want)


def test_singlestreamv_bursts_split_at_127():
    """The noisy rows buffer more than 127 singletons in a row, so the
    burst split is exercised."""
    _, ref, seg = _case(seed=2, T=700, noise=1e4)
    d = engine.protocol_descriptors(seg, "singlestreamv")
    assert int(d.rec_len[d.kind == engine.KIND_BURST].max()) == 127
    for got, want in zip(d, ref_engine.protocol_descriptors(
            ref, "singlestreamv")):
        _equal(got, want)


@pytest.mark.parametrize("knot_kind", KINDS)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_metrics_match(protocol, knot_kind):
    y, ref, seg = _case(method="swing" if knot_kind == "joint" else "angle",
                        seed=3)
    yt = torch.from_numpy(y)
    for got, want in zip(
            engine.protocol_point_metrics(seg, yt, protocol, knot_kind),
            ref_engine.protocol_point_metrics(ref, jnp.asarray(y), protocol,
                                              knot_kind)):
        _equal(got, want)
    want = ref_engine.batched_point_metrics(ref, y, protocol, knot_kind,
                                            eps=1.0)
    got = engine.batched_point_metrics(seg, yt, protocol, knot_kind,
                                       eps=1.0)
    for name in ("ratio", "latency", "error"):
        assert getattr(got, name).dtype == torch.float64
        _equal(getattr(got, name), getattr(want, name))
    # The device |error| surface substitutes for the line evaluation.
    abs_err = np.abs(np.asarray(jax_pla.propagate_lines(ref)) - y)
    want = ref_engine.batched_point_metrics(ref, y, protocol, knot_kind,
                                            abs_err=abs_err)
    got = engine.batched_point_metrics(seg, yt, protocol, knot_kind,
                                       abs_err=torch.from_numpy(abs_err))
    _equal(got.error, want.error)


@pytest.mark.parametrize("knot_kind", KINDS)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_encode_batch_bytes_match(protocol, knot_kind):
    y, ref, seg = _case(seed=4, S=4, T=300)
    assert engine.encode_batch(seg, torch.from_numpy(y), protocol,
                               knot_kind) == \
        ref_engine.encode_batch(ref, y, protocol, knot_kind)


def test_eps_guarantee_violation_raises_like_reference():
    y, ref, seg = _case(seed=5, S=3, T=120)
    with pytest.raises(ValueError) as want:
        ref_engine.batched_point_metrics(ref, y, "singlestream", eps=0.01)
    with pytest.raises(ValueError) as got:
        engine.batched_point_metrics(seg, torch.from_numpy(y),
                                     "singlestream", eps=0.01)
    assert str(got.value) == str(want.value)


def test_later_knot_kinds_and_unknown_protocol():
    y, _, seg = _case(seed=6, S=2, T=140)
    for kind in ("continuous", "mixed"):
        with pytest.raises(NotImplementedError, match="later slice"):
            engine.protocol_descriptors(seg, "implicit", kind)
        with pytest.raises(NotImplementedError, match="later slice"):
            engine.encode_batch(seg, y, "implicit", kind)
    with pytest.raises(ValueError, match="unknown protocol"):
        engine.protocol_descriptors(seg, "nope")
    with pytest.raises(ValueError, match="knot_kind"):
        engine.protocol_nbytes(seg, "implicit", "nope")
