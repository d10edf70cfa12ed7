"""Per-node forecasting models (the counterpart of ``repro.models``).
This slice ports the paper's LSTM; the baselines come later."""
from repro_torch.models.base import Model, params_from_numpy
from repro_torch.models.lstm import LSTMModel
