"""GluADFL in PyTorch for NVIDIA Hopper: the port of ``repro`` (JAX).

The package keeps ``repro``'s module layout and names, so each module's
JAX counterpart sits at the same path under ``src/repro/``.  It imports
``torch`` and numpy only: never ``jax`` and never ``repro``, not even
its JAX-free modules (those are copied here).  Every kernel that the
JAX package writes in Pallas is a hand-written CUDA kernel here, under
``kernels/csrc/``, with a plain PyTorch twin in ``kernels/ref.py``.

Among the slices ported: population-model serving (``data`` ->
``models.lstm`` -> ``kernels`` (``lstm_forward``) -> ``serve`` ->
``launch.serve``); training (``config``, ``optim``, ``core``
(topology, schedules, gossip and its plan, the trainer) -> ``kernels``
(``gossip_mix*``, ``lstm_forward`` for evaluation) -> ``metrics`` ->
``launch.train``), over several processes with the sharded mixer
(``core.distributed``, ``launch.mesh``, ``launch.multihost``); and the
LM zoo's dense and VLM
prefill and decode (``config`` registry, ``configs`` -> ``arch``
(``build_arch``, ``lm``) -> ``nn`` (layers, attention) -> ``kernels``
(``swa_attention`` on the banded branch) -> ``launch.arch_demo``).
Entry points run on CUDA unless the caller asks for the CPU
(:func:`repro_torch.device.resolve_device`).
"""
