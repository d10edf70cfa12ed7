"""Typed configs, the architecture registry and ``a.b=c`` overrides (a
copy of ``repro.config.base``).  Same fields, same defaults, same
coercion from the dataclass annotation.

Every assigned architecture registers an :class:`ArchConfig` under its
id (``--arch <id>``) in ``repro_torch.configs``, so ``list_archs()``
equals the JAX package's; the paper's own glucose LSTM registers under
``glucose-lstm``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ArchConfig:
    """One selectable architecture.

    ``family`` drives assembly:
      dense | moe | ssm | hybrid | encdec | vlm | lstm
    """

    name: str
    family: str
    citation: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    expert_capacity_factor: float = 1.25
    # attention flavour
    sliding_window: int = 0          # 0 = full attention
    attn_bias: bool = False          # qwen-style QKV bias
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # hybrid (recurrentgemma): pattern of block kinds, e.g. ("rglru","rglru","attn")
    block_pattern: tuple = ()
    lru_width: int = 0
    local_attn_window: int = 2048
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # frames after the (stubbed) conv frontend
    # vlm
    vision_tokens: int = 0           # patch-embedding prefix length (stub frontend)
    # parallel attention+MLP residual branches (PaLM-style) — §Perf
    # beyond-paper variant: halves the per-layer activation all-reduces
    parallel_block: bool = False
    # numerics
    dtype: str = "bfloat16"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def reduced(self) -> "ArchConfig":
        """A small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_chunk=16 if self.ssm_state else 64,
            lru_width=min(self.lru_width, 256) if self.lru_width else 0,
            local_attn_window=64,
            sliding_window=64 if self.sliding_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            block_pattern=self.block_pattern,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline 6ND)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "lstm":
            return emb  # unused for lstm family
        per_layer = 0
        # attention (dense/moe/vlm/encdec decoder)
        attn = (
            d * self.num_heads * self.head_dim
            + 2 * d * self.num_kv_heads * self.head_dim
            + self.num_heads * self.head_dim * d
        )
        if self.family in ("dense", "moe", "vlm"):
            per_layer += attn
            if self.num_experts:
                per_layer += self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            else:
                per_layer += 3 * d * self.d_ff
            per_layer += 2 * d  # norms
            return emb + L * per_layer
        if self.family == "ssm":
            d_inner = self.ssm_expand * d
            per_layer = (
                d * (2 * d_inner + 2 * self.ssm_state * self.ssm_heads)  # in_proj-ish
                + d_inner * d
                + 3 * self.ssm_heads
                + 2 * d
            )
            return emb + L * per_layer
        if self.family == "hybrid":
            w = self.lru_width or d
            rglru = d * 2 * w + w * d + 3 * w + 2 * d
            attn_l = attn + 2 * d
            mlp = 3 * d * self.d_ff
            n_attn = sum(1 for b in self.block_pattern for _ in [b] if b == "attn")
            pat = self.block_pattern or ("rglru", "rglru", "attn")
            n_att = sum(1 for b in pat if b == "attn")
            frac_att = n_att / len(pat)
            return emb + int(L * (frac_att * attn_l + (1 - frac_att) * rglru + mlp))
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            dec = L * (2 * attn + 2 * d * self.d_ff + 3 * d)
            return emb + enc + dec
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Activated params per token (MoE discounts inactive experts)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        total = self.param_count()
        all_experts = L * self.num_experts * 3 * d * self.d_ff
        active = L * self.experts_per_token * 3 * d * self.d_ff
        return total - all_experts + active


_ARCH_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _ARCH_REGISTRY[name] = fn
        return fn

    return deco


def get_arch_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_ARCH_REGISTRY)


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
class SweepConfig:
    """The scenario grid :meth:`repro_torch.core.GluADFL.train_sweep`
    batches into one program; the defaults are the paper's Fig-5 grid
    (3 topologies x 5 inactive ratios, seed 0).  ``seeds`` is a count:
    seeds ``0..seeds-1`` each become a scenario replica.

    The optional axes (``schedules``, ``skews``, ``dp_sigmas``) extend
    the cross product with Markov-sticky staleness, non-IID data skew
    and DP noise levels; their defaults leave the grid the classic
    3-axis one (3-tuple labels)."""

    topologies: tuple = ("ring", "cluster", "random")
    inactive_ratios: tuple = (0.0, 0.3, 0.5, 0.7, 0.9)
    seeds: int = 1
    schedules: tuple = ()             # e.g. ("bernoulli", "markov")
    skews: tuple = ()                 # e.g. (0.0, 0.5, 1.0), mg/dL-shift strengths
    dp_sigmas: tuple = ()             # e.g. (0.0, 0.01, 0.05), gossip DP sigma

    def seed_list(self) -> tuple:
        return tuple(range(self.seeds))


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
