"""GluADFL's federated core (the single-process counterpart of
``repro.core``): the trainer, participation schedules, topologies,
gossip mixing and the resolved gossip plan."""
from repro_torch.core.gluadfl import DEFAULT_CHUNK, FLState, GluADFL
from repro_torch.core.gossip_plan import GossipPlanError, choose_gossip_repr, resolve_gossip_plan
