"""The port's kernels: hand-written CUDA for Hopper under ``csrc/``,
built by ``_build.py`` and launched through a ctypes wrapper
(``lstm_cell.py``), with plain PyTorch twins in ``ref.py`` and the
CUDA-or-CPU dispatch in ``ops.py``.

  lstm_forward — L LSTM steps + linear head, per-group weights
                 (ports ``repro.kernels.lstm_cell.lstm_cell_pallas``)
"""
from repro_torch.kernels.ops import lstm_forward
