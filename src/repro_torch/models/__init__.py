"""Per-node forecasting models (the counterpart of ``repro.models``):
the paper's LSTM and the baselines it is compared against (linear
regression, N-BEATS, N-HiTS, gradient-boosted trees).  The trainable
ones share the ``Model`` interface (``init``/``apply``/``apply_nodes``
on flat param dicts), so every trainer is model-agnostic."""
from repro_torch.models.base import Model, flatten_tree, get_model, params_from_numpy
from repro_torch.models.gbt import GBTParams, GradientBoostedTrees
from repro_torch.models.linear import LinearModel
from repro_torch.models.lstm import LSTMModel
from repro_torch.models.nbeats import NBeatsModel
from repro_torch.models.nhits import NHiTSModel

MODEL_REGISTRY = {
    "lstm": LSTMModel,
    "lr": LinearModel,
    "nbeats": NBeatsModel,
    "nhits": NHiTSModel,
}
