"""Pairwise-masked secure aggregation for gossip (``gossip_impl="masked"``;
the counterpart of ``repro.core.secure_agg``).

Every unordered node edge ``(u, v)`` that appears inside a round's
mixing neighborhood gets a mask ``z_uv`` known only to its two
endpoints, added with opposite signs to what each endpoint puts on the
wire: ``+z`` on the lower node id, ``-z`` on the higher.  The paper's
mixing rows are uniform (every kept participant of row ``n`` carries
the weight ``1/deg``), so inside row ``n``'s contraction a pair's two
weighted terms are ``u*z`` and ``u*(-z)``, exact IEEE negations whose
sum is ``+0.0``: the aggregate is bitwise the unmasked gossip, while no
simulated wire equals a node's raw parameters.

Wire model, per mixing row ``n`` with participants ``S_n`` = the valid
slots of its ``(N, B+1)`` neighbor-table row (slot 0 is self, padding
has weight 0):

  ``wire[n, b] = w[idx[n, b]] + sum_{a in S_n, a != b} +-z_edge(a, b)``

Threat model (as in the JAX package): honest-but-curious neighbors.  A
recipient knows its own edges' masks, not those its neighbor shares with
the row's other participants, so ``w_b`` is hidden whenever
``|S_n| >= 3``.  Inactive nodes' rows have one valid slot and admit no
pair, so dropouts leave the cancellation intact by construction.

The port's parameters are one flat ``(N, D)`` buffer (the leaves'
segments in ``utils.pytree.ParamLayout`` order), so a round's masks are
one ``(N, P, D)`` tensor over the flat row, ``P = S(S-1)/2`` slot pairs
(28 at B=7).  They come from a *mask source*, a callable
``(idx, wgt) -> (N, P, D)`` that gives rows sharing an edge the same
vector for it:

  * production: :func:`edge_mask_source`, one normal vector per
    distinct edge drawn from a ``torch.Generator`` of its own
    (:func:`mask_generator`), never from the round's draws, so arming
    masks moves no other draw (JAX folds its mask key off the round key
    with :data:`MASK_STREAM_TAG` for the same reason);
  * tests: JAX's own per-leaf masks, concatenated in layout order.

A sweep gives each scenario a source of its own
(:func:`sweep_mask_sources`), seeded as a serial run with the
scenario's seed would seed it.  On the sharded mixer every rank's
source draws the whole round's masks from the same seed, and each rank
adds the cancellation term of its own rows (``GossipPlan.gossip``), so
a masked sharded run is bitwise its unmasked twin as on one process.

The trainer never materializes wires: it mixes plainly and adds
:func:`masked_mix_zero`, computed term by term so that each pair
contributes ``u*z + u*(-z) = +0.0`` and the mask generation stays live
(it is priced under the ``round.secure_mask`` span).
:func:`simulate_wires` materializes the wires for the privacy and
cancellation checks only.
"""
from __future__ import annotations

from typing import Callable

import torch

# separates the mask stream from every other consumer of randomness
# (ascii "mask", the JAX package's fold_in tag)
MASK_STREAM_TAG = 0x6D61736B

MaskSource = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def pair_slots(num_slots: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The unordered slot pairs ``(a, b)``, ``a < b``, of a table row of
    ``num_slots`` slots, as two tuples (first slots, second slots)."""
    pairs = [(a, b) for a in range(num_slots) for b in range(a + 1, num_slots)]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def _pairs(idx: torch.Tensor, wgt: torch.Tensor):
    """Slot-index tensors of the pairs, the node ids at both slots
    (N, P), and which pairs are valid: both slots weighted and two
    distinct nodes."""
    pa_t, pb_t = pair_slots(idx.shape[1])
    pa = torch.tensor(pa_t, dtype=torch.long, device=idx.device)
    pb = torch.tensor(pb_t, dtype=torch.long, device=idx.device)
    ida, idb = idx[:, pa], idx[:, pb]
    valid = (wgt[:, pa] > 0) & (wgt[:, pb] > 0) & (ida != idb)
    return pa, pb, ida, idb, valid


def edge_masks(idx: torch.Tensor, wgt: torch.Tensor, masks: torch.Tensor):
    """The per-(row, pair) masks of one round, as the JAX package's
    ``_edge_masks``: ``(z, sign_a, pa, pb)`` where ``z`` (N, P, D) fp32
    is ``masks`` zeroed on invalid pairs, ``sign_a`` (N, P, 1) is the
    sign the pair's first slot carries (+1 when it holds the lower node
    id) and ``pa``/``pb`` are the pairs' slot indices."""
    pa, pb, ida, idb, valid = _pairs(idx, wgt)
    z = torch.where(valid[..., None], masks.to(torch.float32), 0.0)
    sign_a = torch.where(ida <= idb, 1.0, -1.0).to(torch.float32)[..., None]
    return z, sign_a, pa, pb


def masked_mix_zero(idx: torch.Tensor, wgt: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """The weighted mask sum of the round's contraction, (N, D): every
    element exactly ``+0.0``.  Summed as the JAX package does,
    ``u*(s*z) + u*(-(s*z))`` per pair, then over pairs; ``u`` is the
    row's uniform weight (``wgt[:, a] == wgt[:, b]`` on every valid
    pair).  ``(idx, wgt)`` is the round's (N, B+1) neighbor table."""
    z, sign_a, pa, _ = edge_masks(idx, wgt, masks)
    u = wgt[:, pa].to(torch.float32)[..., None]
    sz = sign_a * z
    return (u * sz + u * (-sz)).sum(dim=1)


def simulate_wires(params: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                   masks: torch.Tensor) -> torch.Tensor:
    """The wires, for audits and tests only: (N, B+1, D) fp32, where
    ``wire[n, b]`` is what row ``n``'s recipient sees from its slot-b
    participant, the participant's raw row plus its signed masks with
    the row's other valid slots.  ``einsum("nb,nbd->nd", wgt, wires)``
    is the plain sparse mix to float tolerance (the exact path is
    :func:`masked_mix_zero`); a row with two or more valid slots puts
    no raw row on the wire; a single-slot row sends its own row
    unmasked.  The signed masks accumulate pair by pair in pair order,
    first slots then second slots, as the JAX package's scatter-adds
    do."""
    z, sign_a, pa, pb = edge_masks(idx, wgt, masks)
    sz = sign_a * z
    added = torch.zeros((idx.shape[0], idx.shape[1], z.shape[2]), dtype=torch.float32,
                        device=z.device)
    for p, a in enumerate(pa.tolist()):
        added[:, a] += sz[:, p]
    for p, b in enumerate(pb.tolist()):
        added[:, b] += -sz[:, p]
    return params.to(torch.float32)[idx.long()] + added


def mask_generator(seed: int, device) -> torch.Generator:
    """The mask stream's own generator: seeded from a trainer's seed and
    :data:`MASK_STREAM_TAG`, apart from the round's draws.  The seed's
    low 32 bits hold ``seed ^ tag`` (the CPU generator reads only those)
    and its high bits the seed."""
    seed = int(seed)
    return torch.Generator(device=device).manual_seed(
        (seed << 32) | ((seed ^ MASK_STREAM_TAG) & 0xFFFFFFFF))


def edge_mask_source(generator: torch.Generator, dim: int) -> MaskSource:
    """The production mask source: ``(idx, wgt) -> (N, P, dim)`` masks
    with one standard-normal vector per distinct valid edge
    ``(lo, hi)`` of the round, gathered to every (row, pair) that holds
    it, so rows sharing an edge agree on its mask.

    Edges are ranked by sorting ``lo * N + hi`` (invalid pairs sort
    last, under one key of their own), and ``N * P`` vectors are drawn,
    as many as there could be edges: no host sync, and the draw count
    does not depend on the round."""
    def draw(idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
        n = idx.shape[0]
        _, _, ida, idb, valid = _pairs(idx, wgt)
        lo = torch.minimum(ida, idb).long()
        hi = torch.maximum(ida, idb).long()
        key = torch.where(valid, lo * n + hi, n * n).reshape(-1)
        sorted_key, order = torch.sort(key)
        first = torch.ones_like(sorted_key, dtype=torch.bool)
        first[1:] = sorted_key[1:] != sorted_key[:-1]
        rank = torch.empty_like(order).scatter_(0, order, torch.cumsum(first, 0) - 1)
        vectors = torch.randn((key.numel(), dim), generator=generator, device=generator.device)
        return vectors[rank].view(n, -1, dim)
    return draw


def sweep_mask_sources(seeds, dim: int, device) -> list[MaskSource]:
    """One production mask source per swept scenario: scenario g's masks
    from :func:`mask_generator` of ``seeds[g]``, as its serial run
    draws them."""
    return [edge_mask_source(mask_generator(seed, device), dim) for seed in seeds]
