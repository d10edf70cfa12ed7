"""GluADFL's federated core (the single-process counterpart of
``repro.core``): the trainer, participation schedules, topologies,
gossip mixing, the resolved gossip plan (with pairwise-masked secure
aggregation, ``core.secure_agg``), the scenario-sweep engine
(``SweepGrid``, ``GluADFL.train_sweep``), cold-start personalization,
and the baselines it is compared against (FedAvg, MAML/MetaSGD, pooled
supervised training) on their shared chunk engine (``core.chunked``)."""
from repro_torch.config import SweepConfig
from repro_torch.core.async_sched import sweep_active_masks
from repro_torch.core.gluadfl import DEFAULT_CHUNK, FLState, GluADFL, SweepGrid
from repro_torch.core.gossip_plan import (
    GossipPlanError,
    choose_gossip_impl,
    choose_gossip_repr,
    resolve_gossip_plan,
)
from repro_torch.core.topology import (
    mixing_matrix_stacked,
    spectral_gap,
    stacked_adjacency,
    stacked_neighbor_table,
)
from repro_torch.core.personalize import (
    personalize,
    personalize_batch,
    personalize_batch_fn,
    personalize_loop,
)
from repro_torch.core.fedavg import FedAvg
from repro_torch.core.meta import MAML, MetaSGD
from repro_torch.core.supervised import train_supervised
