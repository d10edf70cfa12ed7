"""BG-forecast prediction service (the counterpart of ``repro.serve``):
take a federation checkpoint, personalize it on new patients' short CGM
histories as one batched fine-tune (``core.personalize``), and answer
CGM-window -> BG-forecast requests through a padded-bucket
micro-batching queue, each batch one launch of the ``lstm_forward``
kernel.

  * ``servable.py`` — :class:`GlucoseServable`: checkpoint loading, the
    patient param store, the batched cold-start ``personalize`` entry
    point and the bucketed ``forecast`` method;
  * ``batcher.py``  — :class:`MicroBatcher`: the request queue
    (pad-to-bucket sizing, max-live-batches admission, timeout flush,
    per-request latency accounting), host-side Python with an
    injectable clock.

``launch/serve.py`` is the CLI entry point.
"""
from repro_torch.serve.batcher import MicroBatcher, Request, bucket_for
from repro_torch.serve.servable import GlucoseServable, load_population, replay

__all__ = [
    "GlucoseServable",
    "MicroBatcher",
    "Request",
    "bucket_for",
    "load_population",
    "replay",
]
