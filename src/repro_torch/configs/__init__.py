"""Importing this package populates the architecture registry: one
module per assigned architecture, each registering its
:class:`repro_torch.config.ArchConfig` under the id ``--arch`` accepts.
The same data as ``repro.configs``, copied so the port imports nothing
of the JAX package; ``tests/test_torch_arch.py`` holds them equal."""
from repro_torch.configs import (  # noqa: F401
    glucose_lstm,
    mistral_large_123b,
    llava_next_mistral_7b,
    yi_34b,
    mixtral_8x22b,
    qwen2_5_3b,
    mamba2_370m,
    recurrentgemma_9b,
    whisper_medium,
    yi_6b,
    granite_moe_1b_a400m,
)
