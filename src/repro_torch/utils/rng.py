"""One round's randomness as explicit tensors (replaces
``repro.utils.rng.split_like`` and the trainer's key chain).

JAX's threefry stream cannot be reproduced with a ``torch.Generator``,
so the port's round takes its random draws as inputs: a
:class:`RoundDraws` record.  Production draws it with
:func:`draw_round` from a ``torch.Generator`` on the device; the parity
tests draw the same record with ``jax.random`` in ``GluADFL._round``'s
split order and hand it in.  The cold-start fine-tune
(``core.personalize``) takes its minibatch indices the same way, from
:func:`draw_personalize`.  The sweep engine draws G scenarios' rounds
with :func:`draw_sweep`, one generator per scenario, each in the order
a serial run draws, stacked along a leading G.  The baselines draw the
same way: a FedAvg round is a :class:`RoundDraws` without scores
(:func:`draw_round` on a static topology), a MAML/MetaSGD meta-step a
:class:`MetaDraws`
(:func:`draw_meta`), a pooled supervised step one (B,) index vector
(:func:`draw_supervised`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RoundDraws:
    """The draws one round consumes.

    * ``u_act``     (N,) uniforms in [0, 1): the activity schedule's draw;
    * ``scores``    (N, N) uniforms for the random topology, else None;
    * ``batch_idx`` (N, local_steps, batch) int64: window indices, each
      in ``[0, max(count_n, 1))``;
    * ``dp_noise``  (N, D) standard normals, unscaled, when local DP is
      on, else None (the trainer scales them by sigma).
    """

    u_act: torch.Tensor
    scores: torch.Tensor | None
    batch_idx: torch.Tensor
    dp_noise: torch.Tensor | None = None

    def rows(self, lo: int, hi: int) -> "RoundDraws":
        """The draws of nodes ``lo..hi-1``: each field's rows (a rank's
        block of a round drawn for the whole federation)."""
        def cut(t):
            return None if t is None else t[lo:hi]
        return RoundDraws(cut(self.u_act), cut(self.scores), cut(self.batch_idx),
                          cut(self.dp_noise))


def draw_round(
    generator: torch.Generator,
    counts: torch.Tensor,
    *,
    local_steps: int,
    batch_size: int,
    random_topology: bool,
    dp_dim: int = 0,
) -> RoundDraws:
    """Draw one round on ``generator``'s device.  ``counts`` (N,) are
    the nodes' true window counts; ``dp_dim`` > 0 also draws the
    (N, dp_dim) DP noise."""
    dev = generator.device
    n = counts.shape[0]
    u_act = torch.rand(n, generator=generator, device=dev)
    scores = torch.rand((n, n), generator=generator, device=dev) if random_topology else None
    batch_idx = _uniform_indices(generator, counts.to(dev, torch.int64).clamp_min(1),
                                 local_steps, batch_size)
    noise = None
    if dp_dim:
        noise = torch.randn((n, dp_dim), generator=generator, device=dev)
    return RoundDraws(u_act, scores, batch_idx, noise)


def draw_sweep(
    generators,
    counts: torch.Tensor,
    *,
    local_steps: int,
    batch_size: int,
    resample,
    dp_dim: int = 0,
) -> RoundDraws:
    """One swept round: scenario g's :func:`draw_round` from
    ``generators[g]``, with scores only where ``resample[g]`` (a random
    topology), stacked into one :class:`RoundDraws` with a leading G:
    ``u_act`` (G, N), ``scores`` (G, N, N) with zeros for the static
    scenarios (None when none resamples), ``batch_idx``
    (G, N, local_steps, batch), ``dp_noise`` (G, N, dp_dim) or None."""
    rounds = [draw_round(gen, counts, local_steps=local_steps, batch_size=batch_size,
                         random_topology=bool(rs), dp_dim=dp_dim)
              for gen, rs in zip(generators, resample)]
    scores = None
    if any(r.scores is not None for r in rounds):
        n = counts.shape[0]
        scores = torch.stack([r.scores if r.scores is not None
                              else torch.zeros((n, n), device=r.u_act.device) for r in rounds])
    noise = torch.stack([r.dp_noise for r in rounds]) if dp_dim else None
    return RoundDraws(torch.stack([r.u_act for r in rounds]), scores,
                      torch.stack([r.batch_idx for r in rounds]), noise)


def _uniform_indices(generator: torch.Generator, hi: torch.Tensor, steps: int,
                     batch: int) -> torch.Tensor:
    """(len(hi), steps, batch) int64 indices, row p uniform on
    ``[0, hi[p])``: floor(u * hi) over float64 uniforms, like
    ``jax.random.randint``; the clamp guards the rounding at u -> 1."""
    u = torch.rand((hi.shape[0], steps, batch), generator=generator, device=generator.device,
                   dtype=torch.float64)
    return torch.minimum((u * hi[:, None, None]).long(), hi[:, None, None] - 1)


def clamped_batch(batch_size: int, n_rows: int) -> int:
    """The fine-tune's minibatch: ``batch_size`` clamped to the padded
    history length ``n_rows`` (and at least 1)."""
    return max(1, min(batch_size, n_rows))


def draw_personalize(
    generator: torch.Generator,
    counts: torch.Tensor,
    n_rows: int,
    steps: int,
    batch_size: int,
) -> torch.Tensor:
    """The cold-start fine-tune's minibatch indices for P patients on
    ``generator``'s device: (P, steps, bs) int64 with
    ``bs = clamped_batch(batch_size, n_rows)``, patient p's drawn with
    replacement from ``[0, max(min(counts[p], n_rows), 1))``, so padded
    rows are never sampled and a history shorter than a batch still
    takes ``bs`` draws from its real rows."""
    hi = torch.as_tensor(counts, device=generator.device).to(torch.int64)
    hi = hi.clamp(max=n_rows).clamp_min(1)
    return _uniform_indices(generator, hi, steps, clamped_batch(batch_size, n_rows))


@dataclass
class MetaDraws:
    """The draws one MAML/MetaSGD meta-step consumes, the N patients
    being its tasks:

    * ``support`` (N, inner_steps, batch) int64: each inner step's
      window indices;
    * ``query``   (N, batch) int64: the query batch the adapted params
      are scored on.
    Both in ``[0, max(count_n, 1))``."""

    support: torch.Tensor
    query: torch.Tensor


def draw_meta(generator: torch.Generator, counts: torch.Tensor, *, inner_steps: int,
              batch_size: int) -> MetaDraws:
    """One meta-step's support and query batches on ``generator``'s
    device."""
    hi = counts.to(generator.device, torch.int64).clamp_min(1)
    support = _uniform_indices(generator, hi, inner_steps, batch_size)
    return MetaDraws(support, _uniform_indices(generator, hi, 1, batch_size)[:, 0])


def draw_supervised(generator: torch.Generator, n_rows: int, batch_size: int) -> torch.Tensor:
    """One pooled step's (batch,) window indices in ``[0, n_rows)``."""
    hi = torch.tensor([max(n_rows, 1)], device=generator.device)
    return _uniform_indices(generator, hi, 1, batch_size)[0, 0]
