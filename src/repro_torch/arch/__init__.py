"""The LM-architecture zoo's uniform API (a port of ``repro.arch``):
``build_arch(cfg)`` returns an :class:`Arch` whose ``prefill_fn`` and
``decode_fn`` run the dense and VLM families (``arch/lm.py``) and the
RG-LRU hybrid (``arch/hybrid_lm.py``); the other families raise
``NotImplementedError`` until they are ported."""
from repro_torch.arch.api import SHAPES, Arch, ShapeSpec, build_arch
