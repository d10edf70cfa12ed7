"""The port's CUDA kernel on the card: held against its plain twin, a
row's result bitwise independent of the launch it shares, the wrapper's
refusals, and the servable's bitwise contract through the kernel.

These tests need a CUDA device and skip elsewhere (decided inside the
``cuda`` fixture).  They import neither ``jax`` nor ``repro``, so they
run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lstm_cell
from repro_torch.kernels.ref import lstm_forward_plain
from repro_torch.launch.serve import selfcheck
from repro_torch.models import LSTMModel
from repro_torch.serve import GlucoseServable, MicroBatcher, Request, replay

pytestmark = pytest.mark.gpu

ATOL = 1e-5  # fp32 summation order over 12 recurrent steps
L = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _forward_inputs(g, r, steps, isz, hsz, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(g, r, steps, isz)),
        rng.normal(size=(g, isz, 4 * hsz)) / np.sqrt(isz),
        rng.normal(size=(g, hsz, 4 * hsz)) / np.sqrt(hsz),
        rng.normal(size=(g, 4 * hsz)),
        rng.normal(size=(g, hsz, 1)) / np.sqrt(hsz),
        rng.normal(size=(g, 1)),
    )
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays)


@pytest.mark.parametrize("g,r,steps,isz,hsz", [(1, 1, 12, 1, 8), (37, 1, 12, 1, 32),
                                               (64, 1, 12, 1, 128), (5, 3, 1, 3, 16)])
def test_kernel_matches_plain(cuda, g, r, steps, isz, hsz):
    args = _forward_inputs(g, r, steps, isz, hsz, seed=g, device=cuda)
    before = lstm_cell.LAUNCHES
    got = lstm_cell.lstm_forward(*args)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES == before + 1
    torch.testing.assert_close(got, lstm_forward_plain(*args), rtol=0, atol=ATOL)


def test_kernel_row_is_bitwise_independent_of_batch(cuda):
    args = _forward_inputs(16, 1, L, 1, 128, seed=6, device=cuda)
    full = lstm_cell.lstm_forward(*args)
    for i in (0, 5, 15):
        one = lstm_cell.lstm_forward(*(a[i : i + 1] for a in args))
        assert torch.equal(one[0], full[i])


def test_kernel_wrapper_checks_shape_dtype_contiguity(cuda):
    args = list(_forward_inputs(2, 1, L, 1, 8, seed=8, device=cuda))
    before = lstm_cell.LAUNCHES
    with pytest.raises(ValueError, match="wh must be"):
        lstm_cell.lstm_forward(*args[:2], args[2][:, :, :16].contiguous(), *args[3:])
    with pytest.raises(TypeError, match="float32"):
        lstm_cell.lstm_forward(args[0].double(), *args[1:])
    strided = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell.lstm_forward(*args[:2], strided, *args[3:])
    assert lstm_cell.LAUNCHES == before


def test_served_equals_direct_apply_through_the_kernel(cuda):
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16))
    windows = np.random.default_rng(6).normal(size=(37, L)).astype(np.float32)
    reqs = [Request(rid=i, patient=0, window=w) for i, w in enumerate(windows)]
    before = lstm_cell.LAUNCHES
    preds = replay(sv, MicroBatcher(sv.buckets), reqs)
    assert lstm_cell.LAUNCHES > before
    assert selfcheck(sv, reqs, preds) == 0
