"""The LM-architecture zoo's uniform API (a port of ``repro.arch``):
``build_arch(cfg)`` returns an :class:`Arch` whose ``prefill_fn`` and
``decode_fn`` run every family of the zoo: dense, MoE and VLM
(``arch/lm.py``), the Mamba-2 SSM (``arch/ssm_lm.py``), the RG-LRU
hybrid (``arch/hybrid_lm.py``) and the Whisper encoder-decoder
(``arch/encdec.py``), and whose ``loss_fn`` the train step
(``TrainState``, ``init_train_state``, ``make_train_step``) differentiates."""
from repro_torch.arch.api import SHAPES, Arch, ShapeSpec, TrainState, build_arch
