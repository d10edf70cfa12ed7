"""The yardstick's FLOP and byte counts against hand counts at the
cells' shapes."""
import json

import pytest

from portbench_tiny import PB

from portbench import costs


def test_window_flops_by_hand():
    # L steps of x @ wx (I x 4H) and h @ wh (H x 4H), 2 FLOPs a multiply-add, and the head
    assert costs.window_flops(12, 1, 128) == 12 * (2 * 1 * 512 + 2 * 128 * 512) + 2 * 128 \
        == 1_585_408
    assert costs.window_flops(12, 1, 512) == 25_216_000


def test_train_flops_by_hand():
    # a swept Fig-5 round with 1,763 active rows of batch 64: forward + backward = 3 forwards
    assert costs.train_flops(1763, 64, 1, 12, 1, 128) == pytest.approx(
        3 * 1763 * 64 * 1_585_408)
    assert costs.train_flops(158, 64, 1, 12, 1, 512) / 1e12 == pytest.approx(0.7649, abs=1e-4)


def test_lstm_forward_cost_by_hand():
    # the Fig-5 sweep's eval launch (G=15, R=2,034, L=12, I=1, H=128)
    nbytes, ops = costs.lstm_forward_cost(15, 2034, 12, 1, 128)
    assert nbytes == 4 * (15 * 2034 * 12 + 15 * 512 + 15 * 128 * 512 + 15 * 512 + 15 * 128
                          + 15 + 15 * 2034)
    per_step = 2 * 129 * 512 + 2 * 512 + 4 * 128
    assert ops == 15 * 2034 * (12 * per_step + 257)
    # PERF.md's kernel table: the bound of this launch is 0.730 ms, set by the operations
    assert costs.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.730, abs=5e-4)
    assert ops / costs.FP32_OPS_PER_S > nbytes / costs.HBM_BYTES_PER_S


def test_gossip_mix_sparse_cost_by_hand():
    # PERF.md's kernel table: N=226, D=66,689, 8 slots, 162 active: 120.6 MB, 0.0360 ms
    nbytes, ops = costs.gossip_mix_sparse_cost(226, 66_689, 8, 162)
    assert nbytes == 2 * 4 * 226 * 66_689 + 226 * 8 * (4 + 4) + 4 * 226
    assert nbytes / 1e6 == pytest.approx(120.6, abs=0.05)
    assert ops == 162 * 66_689 * 8 * 2
    assert costs.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0360, abs=5e-5)


@pytest.mark.parametrize("name", ["gluadfl-lstm128-replace-bg", "gluadfl-lstm512-replace-bg"])
def test_params_per_node_is_the_models(name):
    from repro_torch.models import LSTMModel

    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    m = cfg["model"]
    lstm = LSTMModel(history_len=m["history_len"], hidden=m["hidden"], input_size=m["input_size"])
    import torch

    params = lstm.init(torch.Generator().manual_seed(0))
    assert sum(v.numel() for v in params.values()) == cfg["params_per_node"]
