"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode.  The file imports nothing of JAX, so it
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact equality (``torch.equal``), since each plain version
repeats its kernel's arithmetic, fused multiply-adds included.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import evaluate, pla
from repro_torch.data import synthetic
from repro_torch.kernels.angle import angle_init_carry, angle_plain, \
    launch_angle
from repro_torch.kernels.common import LAUNCHES, pad_streams, \
    reset_launches
from repro_torch.kernels.reconstruct import (launch_recon, launch_recon_err,
                                             recon_err_plain,
                                             recon_init_carry, recon_plain)
from repro_torch.kernels.swing import launch_swing, swing_init_carry, \
    swing_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _walk(dev, S=70, T=400, seed=3):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(0, 0.5, (S, T)), axis=1).astype(np.float32)
    y[-1] = rng.normal(0, 5.0, T)
    return torch.from_numpy(y).to(dev)


@pytest.mark.parametrize("method", ["swing", "angle"])
def test_segmenter_kernel_equals_plain(cuda, method):
    """Events and carry equal, offline (forced break) and resumed."""
    launch, plain, init = {
        "swing": (launch_swing, swing_plain, swing_init_carry),
        "angle": (launch_angle, angle_plain, angle_init_carry),
    }[method]
    y_t = pad_streams(_walk(cuda))                  # (401, 70)
    eps = torch.linspace(0.2, 3.0, 70, device=cuda)
    carry = init(70, cuda)
    for lo, hi, t_real in ((0, 150, -1), (150, 401, 250)):
        k = launch(y_t[lo:hi].contiguous(), eps, carry, max_run=127,
                   t_real=t_real)
        p = plain(y_t[lo:hi], eps, carry, max_run=127, t_real=t_real)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        carry = k[3]


def test_recon_kernels_equal_plain(cuda):
    seg = pla.angle_segment(_walk(cuda, seed=7), 1.0, max_run=64)
    brk_t, a_t, v_t = pla.time_major_events(seg)
    y_t = _walk(cuda, seed=7).t().contiguous()
    carry = recon_init_carry(70, cuda)
    for lo, hi in ((250, 400), (0, 250)):   # suffix first
        k = launch_recon(brk_t[lo:hi], a_t[lo:hi], v_t[lo:hi], carry)
        p = recon_plain(brk_t[lo:hi], a_t[lo:hi], v_t[lo:hi], carry)
        ke = launch_recon_err(brk_t[lo:hi], a_t[lo:hi], v_t[lo:hi],
                              y_t[lo:hi], carry)
        pe = recon_err_plain(brk_t[lo:hi], a_t[lo:hi], v_t[lo:hi],
                             y_t[lo:hi], carry)
        for a, b in zip(k + ke, p + pe):
            assert torch.equal(a, b)
        carry = k[1]


@pytest.mark.parametrize("key", ["Sw", "A1", "A2", "A3"])
def test_evaluate_on_card_equals_cpu(cuda, key):
    """The slice end to end: the card (kernels) and the CPU (plain
    versions) give equal metrics and byte counts, and the kernels ran."""
    method, proto = evaluate.COMBINATIONS[key]
    y = synthetic.make_batch("gps", 40, 900, np.random.default_rng(5),
                             device=cuda)
    reset_launches()
    got = evaluate.evaluate_batched(method, proto, y, 10.0,
                                    reconstruct="kernel", device=cuda)
    assert LAUNCHES[method] == 1 and LAUNCHES["recon_err"] == 1
    want = evaluate.evaluate_batched(method, proto, y.cpu(), 10.0,
                                     reconstruct="kernel", device="cpu")
    for name in ("ratio", "latency", "error"):
        assert torch.equal(getattr(got.metrics, name).cpu(),
                           getattr(want.metrics, name))
    np.testing.assert_array_equal(got.overall_ratio, want.overall_ratio)
    np.testing.assert_array_equal(got.n_records, want.n_records)
