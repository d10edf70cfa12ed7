"""Experiment configs and ``a.b=c`` overrides (a copy of the federated
part of ``repro.config.base``; the LM architecture registry is not
ported).  Same fields, same defaults, same coercion from the dataclass
annotation."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FLConfig:
    topology: str = "random"          # ring | cluster | random | star | full
    num_nodes: int = 12
    comm_batch: int = 7               # B in Algorithm 1 (paper uses B=7)
    rounds: int = 100
    local_steps: int = 1
    inactive_ratio: float = 0.0       # fraction of nodes inactive per round
    schedule: str = "bernoulli"       # bernoulli | markov (sticky staleness)
    p_stay_active: float = 0.9        # markov: P(active -> active)
    p_stay_inactive: float = 0.7      # markov: P(inactive -> inactive)
    data_skew: float = 0.0            # non-IID per-node mg/dL shift strength
    cluster_size: int = 4
    seed: int = 0


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ohiot1dm"         # ohiot1dm | abc4d | ctr3 | replace-bg
    history_len: int = 12             # L = 12 (2 hours at 5-min sampling)
    horizon: int = 6                  # H = 6 (30 minutes)
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 64
    steps: int = 200
    optimizer: str = "adam"
    hidden_size: int = 128            # LSTM hidden (paper sweeps {128,256,512})
    seed: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    fl: FLConfig = field(default_factory=FLConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _coerce(val: str, typ: Any) -> Any:
    if typ is bool:
        return val.lower() in ("1", "true", "yes")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``a.b=c`` style overrides to (nested, frozen) dataclasses."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        cfg = _set_path(cfg, key.split("."), val)
    return cfg


def _set_path(cfg: Any, parts: list[str], val: str) -> Any:
    name = parts[0]
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    if name not in fields:
        raise KeyError(f"no config field {name!r} on {type(cfg).__name__}")
    if len(parts) == 1:
        typ = fields[name].type
        typ = {"int": int, "float": float, "str": str, "bool": bool}.get(typ, typ)
        return dataclasses.replace(cfg, **{name: _coerce(val, typ)})
    sub = getattr(cfg, name)
    return dataclasses.replace(cfg, **{name: _set_path(sub, parts[1:], val)})
