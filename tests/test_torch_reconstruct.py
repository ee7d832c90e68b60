"""Port reconstruction and record framing against the JAX reference.

``repro_torch`` reconstructs through the reverse-walk kernels (their plain
versions on the CPU); the reference is ``jax_pla.propagate_lines`` and
``|propagate_lines(seg) - y|``.  Segmentations come from the reference's
jnp segmenters, so disjoint (angle, disjoint) and joint (swing) lines are
both exercised.  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_pla
from repro_torch.core import convert, pla
from repro_torch.kernels import ops
from repro_torch.kernels.reconstruct import recon_cuda, recon_err_cuda

SEGMENTERS = ("swing", "angle", "disjoint")


def _case(method, seed=0, S=12, T=300, eps=1.0, max_run=64):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(0, 0.6, (S, T)), axis=1).astype(np.float32)
    y[-1] = rng.normal(0, 4.0, T)  # a noisy row: many short segments
    ref = getattr(jax_pla, f"{method}_segment")(jnp.asarray(y), eps,
                                                 max_run=max_run)
    seg = convert.segment_output_from_reference(*ref, device="cpu")
    return y, ref, seg


@pytest.mark.parametrize("method", SEGMENTERS)
def test_propagate_lines_matches_reference(method):
    _, ref, seg = _case(method)
    np.testing.assert_array_equal(pla.propagate_lines(seg).numpy(),
                                  np.asarray(jax_pla.propagate_lines(ref)))


def test_propagate_lines_open_tail_extends_last_line():
    """A row without a closing break extends the last column's line, as
    the reference's walk does."""
    _, ref, seg = _case("angle", seed=4, S=3, T=90)
    brk = np.asarray(ref.breaks).copy()
    brk[:, -1] = False
    ref_open = jax_pla.SegmentOutput(jnp.asarray(brk), ref.a, ref.v)
    got = pla.propagate_lines(seg._replace(breaks=torch.from_numpy(brk)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pla.propagate_lines(ref_open)))


@pytest.mark.parametrize("method", SEGMENTERS)
def test_reconstruct_and_error_match_reference(method):
    y, ref, seg = _case(method, seed=1)
    want = np.asarray(jax_pla.propagate_lines(ref))
    np.testing.assert_array_equal(ops.reconstruct_cuda(seg).numpy(), want)
    out, err = ops.reconstruct_error_cuda(seg, torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(err.numpy(), np.abs(want - y))


@pytest.mark.parametrize("cuts", [(300,), (150, 300), (7, 64, 65, 200, 300)])
def test_suffix_first_chunked_carry(cuts):
    """Slabs walked latest first, each handing its carry to the slab
    before it, equal the one-shot walk bit for bit."""
    y, ref, seg = _case("swing", seed=2)
    brk_t, a_t, v_t = pla.time_major_events(seg)
    y_t = torch.from_numpy(y).t().contiguous()
    out, err = torch.empty_like(a_t), torch.empty_like(a_t)
    out2 = torch.empty_like(a_t)
    carry = carry2 = None
    bounds = (0,) + cuts
    for lo, hi in reversed(list(zip(bounds[:-1], bounds[1:]))):
        out[lo:hi], err[lo:hi], carry = recon_err_cuda(
            brk_t[lo:hi], a_t[lo:hi], v_t[lo:hi], y_t[lo:hi], carry)
        out2[lo:hi], carry2 = recon_cuda(brk_t[lo:hi], a_t[lo:hi],
                                         v_t[lo:hi], carry2)
    want = np.asarray(jax_pla.propagate_lines(ref))
    np.testing.assert_array_equal(out.t().numpy(), want)
    np.testing.assert_array_equal(out2.t().numpy(), want)
    np.testing.assert_array_equal(err.t().numpy(), np.abs(want - y))
    assert torch.equal(carry, carry2)


@pytest.mark.parametrize("method", ("swing", "angle"))
@pytest.mark.parametrize("k_max", [8, 40, 300])
def test_records_match_reference(method, k_max):
    """to_records, records_to_events and decode_records, with and without
    overflowing rows (k_max=8 overflows every row)."""
    _, ref, seg = _case(method, seed=3, S=6, T=160)
    T = 160
    rec_ref = jax_pla.to_records(ref, k_max)
    rec = pla.to_records(seg, k_max)
    for got, want in zip(rec, rec_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rec.seg_end.dtype == torch.int32 and rec.count.dtype == torch.int32
    ev_ref = jax_pla.records_to_events(rec_ref, T)
    ev = pla.records_to_events(rec, T)
    for got, want in zip(ev, ev_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pla.decode_records(rec, T).numpy(),
                                  np.asarray(jax_pla.decode_records(rec_ref,
                                                                    T)))
    np.testing.assert_array_equal(
        ops.reconstruct_records_cuda(rec, T).numpy(),
        np.asarray(jax_pla.propagate_lines(ev_ref)))


def test_records_to_events_open_tail():
    """Records whose last segment ends before t_len - 1 extend its line
    to the closing column."""
    _, ref, seg = _case("angle", seed=6, S=4, T=120)
    rec_ref = jax_pla.to_records(ref, 200)
    rec = pla.to_records(seg, 200)
    count = np.asarray(rec_ref.count)
    cut_ref = rec_ref._replace(count=jnp.asarray(count - 1))
    cut = rec._replace(count=torch.from_numpy(count - 1))
    for got, want in zip(pla.records_to_events(cut, 120),
                         jax_pla.records_to_events(cut_ref, 120)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

