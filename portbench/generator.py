"""The benchmark's inputs, made from ``--seed``: the initial params of
every row and each round's draws, for any traffic file.

A traffic file (``portbench/traffic/<name>.json``) names its driver and
the grid it trains: ``topologies`` and ``inactive_ratios`` (their cross
product, topology-major, each scenario repeated ``seeds_per_scenario``
times innermost: the sweep engine's layout), or a single ``topology``
and ``inactive_ratio`` for one federation.  Everything here is plain
PyTorch and draws on the device with ``torch.Generator``s seeded from
``--seed``, in a few large calls:

  * :func:`init_leaves`: every row's LSTM params, the model's scales
    (weights normal over the square root of their fan-in, the forget
    gate's bias 1, the others 0);
  * :class:`Draws`: a round's activity uniforms (G, N), the random
    topology's scores (G, N, N) when a scenario draws its graph, and the
    window indices (G, N, local_steps, batch), each node's uniform over
    its own windows.

The same seed gives the same inputs; :class:`Draws` replays them from
its seed for the reference.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

LEAVES = ("wx", "wh", "b", "w_out", "b_out")


def derive(seed: int, stream: str) -> int:
    """A 63-bit generator seed for ``stream`` from the run's seed (any
    whole number)."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()[:8],
                          "little") >> 1


@dataclass(frozen=True)
class Scenario:
    topology: str
    inactive_ratio: float


def scenarios(traffic: dict) -> list[Scenario]:
    """The traffic's scenarios in the sweep engine's order."""
    if "topologies" in traffic:
        reps = int(traffic.get("seeds_per_scenario", 1))
        return [Scenario(t, float(r)) for t in traffic["topologies"]
                for r in traffic["inactive_ratios"] for _ in range(reps)]
    return [Scenario(traffic["topology"], float(traffic["inactive_ratio"]))]


def init_leaves(model: dict, rows: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Every row's params as leaves (rows, *shape), fp32 on ``device``."""
    hsz, isz = model["hidden"], model["input_size"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "params"))
    a, b = isz * 4 * hsz, (isz + hsz) * 4 * hsz
    z = torch.randn((rows, b + hsz), generator=gen, device=device)
    bias = torch.zeros((rows, 4 * hsz), device=device)
    bias[:, hsz:2 * hsz] = 1.0
    return {
        "wx": z[:, :a].reshape(rows, isz, 4 * hsz) / math.sqrt(isz),
        "wh": z[:, a:b].reshape(rows, hsz, 4 * hsz) / math.sqrt(hsz),
        "b": bias,
        "w_out": z[:, b:].reshape(rows, hsz, 1) / math.sqrt(hsz),
        "b_out": torch.zeros((rows, 1), device=device),
    }


def active_mask(u: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """The Bernoulli schedule: node n of scenario g is active when its
    uniform reaches the scenario's inactive ratio (compared in float32);
    a scenario with no active node activates the one with the largest
    uniform.  (G, N) float32 of 0 and 1."""
    active = (u >= ratios[:, None]).to(torch.float32)
    none = active.amax(dim=1, keepdim=True) == 0
    first = torch.zeros_like(active).scatter_(1, u.argmax(dim=1, keepdim=True), 1.0)
    return torch.where(none, first, active)


class Draws:
    """Each round's draws for G scenarios of N nodes, from ``seed``.

    ``counts`` (N,) are the nodes' true window counts; ``random`` says
    which scenarios draw their graph each round.  With ``record=True``
    each round's active rows per scenario are kept (on the device) for
    the traced run's FLOP count."""

    def __init__(self, seed: int, counts, grid: list[Scenario], local_steps: int, batch: int,
                 device, record: bool = False):
        self.gen = torch.Generator(device=device).manual_seed(derive(seed, "draws"))
        self.hi = torch.as_tensor(counts, dtype=torch.int64, device=device).clamp_min(1)
        self.g, self.n = len(grid), int(self.hi.shape[0])
        self.ratios = torch.tensor([s.inactive_ratio for s in grid], dtype=torch.float32,
                                   device=device)
        self.random = any(s.topology == "random" for s in grid)
        self.shape = (self.g, self.n, local_steps, batch)
        self.device = device
        self.record = record
        self.active: list[torch.Tensor] = []

    def next(self) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
        """One round: ``u`` (G, N), ``scores`` (G, N, N) or None, and
        ``batch_idx`` (G, N, local_steps, batch) int64."""
        dev = self.device
        u = torch.rand((self.g, self.n), generator=self.gen, device=dev)
        scores = None
        if self.random:
            scores = torch.rand((self.g, self.n, self.n), generator=self.gen, device=dev)
        w = torch.rand(self.shape, generator=self.gen, device=dev, dtype=torch.float64)
        hi = self.hi[None, :, None, None]
        idx = torch.minimum((w * hi).long(), hi - 1)
        if self.record:
            self.active.append(active_mask(u, self.ratios).sum(dim=1))
        return u, scores, idx

    def active_rows(self) -> list[list[float]]:
        """The recorded rounds' active rows, one list of G a round."""
        if not self.active:
            return []
        return torch.stack(self.active).cpu().tolist()
