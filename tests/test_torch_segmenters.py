"""Port segmenters (repro_torch) against the JAX reference, exactly.

The same seeded numpy inputs go through ``repro.core.jax_pla`` (the
executable reference; the Pallas kernels do not run on the installed jax)
and through ``repro_torch.core.pla`` on the CPU, where the kernels' plain
versions run.  Tolerance: exact equality of break positions, and of ``a``
and ``v`` at every break (the port writes 0 elsewhere, the reference the
running line).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_pla
from repro_torch.core import convert, pla

METHODS = ("swing", "angle")

# tests/test_kernels.py's shapes, plus one long enough (T >= 4096) that the
# reference unrolls its Angle scan.
SHAPES = [(1, 16), (3, 130), (128, 128), (130, 200), (256, 384), (64, 1024),
          (8, 4096)]

# tests/test_streaming_property.py's FIXED_SPLITS: (T, chunk widths, seed).
FIXED_SPLITS = (
    (105, (1, 31, 32, 40, 1), 0),
    (97, (50, 47), 1),
    (64, (64,), 2),
    (41, (3, 7, 1, 13, 17), 3),
    (9, tuple([1] * 9), 4),
)


def _make(seed, S, T, kind="walk"):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        y = np.cumsum(rng.normal(0, 0.5, (S, T)), axis=1)
    elif kind == "noise":
        y = rng.normal(0, 5.0, (S, T))
    else:  # ramp
        y = np.linspace(0, 10, T)[None, :] * rng.uniform(0.5, 2, (S, 1))
    return y.astype(np.float32)


def _reference(method, y, eps, max_run):
    fn = getattr(jax_pla, f"{method}_segment")
    return fn(jnp.asarray(y), jnp.asarray(eps), max_run=max_run)


def _port(method, y, eps, max_run):
    fn = getattr(pla, f"{method}_segment")
    return fn(torch.from_numpy(y), torch.as_tensor(eps), max_run=max_run)


def assert_same_segmentation(ref, got):
    """Equal breaks; equal ``a`` and ``v`` at every break."""
    brk = np.asarray(ref.breaks)
    np.testing.assert_array_equal(got.breaks.cpu().numpy(), brk)
    np.testing.assert_array_equal(got.a.cpu().numpy()[brk],
                                  np.asarray(ref.a)[brk])
    np.testing.assert_array_equal(got.v.cpu().numpy()[brk],
                                  np.asarray(ref.v)[brk])


def _cat(outs):
    return pla.SegmentOutput(*(torch.cat(parts, dim=1)
                               for parts in zip(*outs)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES)
def test_segmenter_matches_reference_shapes(method, shape):
    S, T = shape
    y = _make(0, S, T)
    ref = _reference(method, y, 1.0, 64)
    got = _port(method, y, 1.0, 64)
    assert got.breaks.shape == (S, T) and got.breaks.dtype == torch.bool
    assert_same_segmentation(ref, got)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["walk", "noise", "ramp"])
@pytest.mark.parametrize("max_run", [64, 127, 256])
@pytest.mark.parametrize("per_stream", [False, True])
def test_segmenter_kinds_eps_max_run(method, kind, max_run, per_stream):
    S, T = 24, 200
    y = _make(1, S, T, kind)
    eps = (np.random.default_rng(9).uniform(0.2, 4.0, S).astype(np.float32)
           if per_stream else np.float32(1.0))
    assert_same_segmentation(_reference(method, y, eps, max_run),
                             _port(method, y, eps, max_run))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("split", FIXED_SPLITS, ids=lambda s: str(s[0]))
def test_chunked_equals_offline(method, split):
    """Inside the port, any chunking is bit-identical to the offline call."""
    T, widths, seed = split
    y = torch.from_numpy(_make(seed, 4, T))
    offline = getattr(pla, f"{method}_segment")(y, 0.5, max_run=16)
    state = pla.init_state(method, 4, 0.5, max_run=16, device="cpu")
    outs, lo = [], 0
    for w in widths:
        state, out = pla.step_chunk(state, y[:, lo:lo + w])
        assert out.breaks.shape[1] == w - (lo == 0)
        outs.append(out)
        lo += w
    state, out = pla.flush(state)
    outs.append(out)
    assert state.t == state.emitted == T and state.carry is None
    got = _cat(outs)
    for g, o in zip(got, offline):
        assert torch.equal(g, o)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("per_stream", [False, True])
def test_resume_reference_state_in_port(method, per_stream):
    """The reference segments the first half; its carry, carried across,
    lets the port finish the stream; the whole equals the reference's
    offline output.  (Outputs after resuming are compared, never carry
    rows: the Pallas Angle kernel leaves ``slo``/``shi`` other than the jnp
    init at a stream's first point, rows phase 0 never reads.)"""
    S, T, half = 6, 240, 97
    y = _make(5, S, T)
    eps = (np.linspace(0.3, 2.0, S).astype(np.float32) if per_stream
           else np.float32(0.8))
    ref_state = jax_pla.init_state(method, S, jnp.asarray(eps), max_run=64)
    ref_state, first = jax_pla.step_chunk(ref_state, jnp.asarray(y[:, :half]))
    carry = convert.carry_from_reference(
        method, tuple(np.asarray(x) for x in ref_state.carry), device="cpu")
    state = dataclasses.replace(
        pla.init_state(method, S, eps, max_run=64, device="cpu"),
        t=ref_state.t, emitted=ref_state.emitted, carry=carry)
    state, rest = pla.step_chunk(state, y[:, half:])
    state, last = pla.flush(state)
    head = convert.segment_output_from_reference(*first, device="cpu")
    assert_same_segmentation(_reference(method, y, eps, 64),
                             _cat([head, rest, last]))


@pytest.mark.parametrize("method", METHODS)
def test_packed_reference_carry_is_taken_as_is(method):
    rows = 6 if method == "swing" else 8
    packed = np.arange(rows * 5, dtype=np.float32).reshape(rows, 5)
    got = convert.carry_from_reference(method, packed, device="cpu")
    np.testing.assert_array_equal(got.numpy(), packed)
    with pytest.raises(ValueError, match="packed"):
        convert.carry_from_reference(method, packed[:-1], device="cpu")


def test_max_stream_t_guard():
    state = pla.init_state("swing", 2, 1.0, device="cpu")
    state = dataclasses.replace(state, t=pla.MAX_STREAM_T - 3)
    with pytest.raises(ValueError, match="2\\^24"):
        pla.step_chunk(state, np.zeros((2, 4), np.float32))
    state, out = pla.step_chunk(state, np.zeros((2, 3), np.float32))
    assert state.t == pla.MAX_STREAM_T


def test_streaming_errors_and_later_methods():
    state = pla.init_state("angle", 2, 1.0, device="cpu")
    with pytest.raises(ValueError, match="no open run"):
        pla.flush(state)
    with pytest.raises(ValueError, match="at least one point"):
        pla.step_chunk(state, np.zeros((2, 0), np.float32))
    with pytest.raises(ValueError, match="chunk must be"):
        pla.step_chunk(state, np.zeros((3, 4), np.float32))
    with pytest.raises(NotImplementedError, match="later|slice"):
        pla.init_state("disjoint", 2, 1.0, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        pla.init_state("nope", 2, 1.0, device="cpu")



def _round_f32(x):
    """Exact rational -> nearest float32, ties to even."""
    from fractions import Fraction
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - x) for v in cands]
    best = min(dist)
    near = [v for v, d in zip(cands, dist) if d == best]
    if len(near) == 2:  # tie: the even mantissa
        near = [v for v in near if not (int(v.view(np.int32)) & 1)]
    return near[0]


def test_fma_f32_rounds_once():
    """fma_f32 is the correctly rounded a*b + c, including the case where
    rounding the float64 sum first would land on a float32 tie."""
    from fractions import Fraction
    from repro_torch.kernels.common import fma_f32
    a = [np.float32(2.0 ** -24 * (1 + 2.0 ** -23))]
    b = [np.float32(1 - 2.0 ** -23)]
    c = [np.float32(1 + 2.0 ** -23)]
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-4, 1e6):
        a += list((rng.normal(0, scale, 300)).astype(np.float32))
        b += list(rng.normal(0, 1.0, 300).astype(np.float32))
        c += list(rng.normal(0, scale, 300).astype(np.float32))
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(1 + 2.0 ** -23)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] != got[0]
