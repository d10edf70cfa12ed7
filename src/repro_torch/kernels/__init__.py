"""The port's kernels: hand-written CUDA for Hopper under ``csrc/``,
built by ``_build.py`` and launched through ctypes wrappers
(``lstm_cell.py``, ``lstm_train.py``, ``gossip_mix.py``,
``swa_attention.py``), with plain
PyTorch twins in ``ref.py`` and the CUDA-or-CPU dispatch in ``ops.py``.

  lstm_forward          L LSTM steps + linear head, per-group weights
                        (ports ``repro.kernels.lstm_cell.lstm_cell_pallas``)
  lstm_gates_fwd        one training step's gates and cell update, and
  lstm_gates_bwd        its backward (``lstm_train.py``; port no Pallas
                        kernel: the JAX package trains under jax.grad)
  gossip_mix            dense gossip mix       (``gossip_mix_pallas``)
  gossip_mix_sparse     neighbor-table mix     (``gossip_mix_sparse_pallas``)
  gossip_mix_dp         dense local-DP mix     (``gossip_mix_dp_pallas``)
  gossip_mix_sparse_dp  sparse local-DP mix    (``gossip_mix_sparse_dp_pallas``)
  swa_attention         causal sliding-window attention over the band,
                        KV heads read in place (``swa_attention_pallas``)

Callers use ``ops``; the package re-exports only ``lstm_forward``, so
that ``repro_torch.kernels.gossip_mix`` and ``.swa_attention`` stay the
wrapper modules.
"""
from repro_torch.kernels.ops import lstm_forward
