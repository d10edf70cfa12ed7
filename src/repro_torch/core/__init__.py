"""GluADFL's federated core (the counterpart of ``repro.core``): the
trainer, participation schedules, topologies, gossip mixing, the
resolved gossip plan and its backend registry (tree, kernel, sharded),
the sharded mixer over ``torch.distributed`` ranks
(``core.distributed``), pairwise-masked secure aggregation
(``core.secure_agg``), the scenario-sweep engine (``SweepGrid``,
``GluADFL.train_sweep``, on one process or, with the sharded mixer, over
a sweep mesh of ranks), cold-start personalization, and the
baselines it is compared against (FedAvg, MAML/MetaSGD, pooled
supervised training) on their shared chunk engine (``core.chunked``).
Gossip data-parallelism for the LM zoo lives in ``core.gossip_dp``,
which ``repro.core`` does not export either.

It exports what ``repro.core`` exports, except the Pallas-era
``gossip_mix_kernel``/``gossip_mix_dp_kernel`` entry points (the
kernels are ``kernels.ops``)."""
from repro_torch.config import SweepConfig
from repro_torch.core.async_sched import (
    bernoulli_active,
    markov_active,
    staleness_update,
    sweep_active_masks,
)
from repro_torch.core.gluadfl import DEFAULT_CHUNK, FLState, GluADFL, SweepGrid
from repro_torch.core.distributed import sharded_gossip_mix, sharded_gossip_mix_gather
from repro_torch.core.gossip import gossip_mix_tree
from repro_torch.core.gossip_plan import (
    BackendCaps,
    GossipPlan,
    GossipPlanError,
    MixBackend,
    choose_gossip_impl,
    choose_gossip_repr,
    mix_backends,
    register_mix_backend,
    resolve_gossip_plan,
)
from repro_torch.core.topology import (
    cluster_adjacency,
    full_adjacency,
    mixing_matrix,
    mixing_matrix_stacked,
    random_adjacency,
    ring_adjacency,
    round_adjacency,
    spectral_gap,
    stacked_adjacency,
    stacked_neighbor_table,
    star_adjacency,
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
