"""The partition rules of the port (``repro_torch.arch.sharding``) and the
dry run's input and state specs (``repro_torch.launch.dryrun``) held
against the JAX package's on the CPU, at full width.

  * ``param_pspecs`` of every registered LM config (not
    ``glucose-lstm``), entry by entry against JAX's: JAX's on
    ``jax.eval_shape`` params, the port's on ``FakeTensorMode`` params,
    under the train rule (tensor-parallel only, and with FSDP over the
    data axes) and the serving rule, on the (16, 16) and (2, 16, 16)
    production meshes.
  * ``batch_shardings`` and ``decode_state_shardings`` on every shape,
    JAX's on ``AbstractMesh``es of the production shapes.
  * The per-rank argument bytes of every (arch x shape x mesh) step that
    the dry run builds, against the bytes of JAX's specs through
    ``NamedSharding(AbstractMesh, spec).shard_shape`` (JAX's
    ``build_step`` rules: its FSDP threshold, its bf16 serving cast).
  * ``tests/test_launch_utils.py``'s divisibility fallback and ring-specs
    roundtrip, on the port; ``placements`` (pod-major, as JAX splits a
    dim over two axes, checked on rank 304's shard of a fake world) and
    the flattened multi-pod mesh.
  * The hints (``constrain_act``, ``constrain_attn``, ``split_heads``,
    ``merge_heads``, ``match_heads``) are the identity on plain tensors,
    and ``serving_mode`` is ``inference_mode`` there.
  * ``ring_mix_params`` with tensor-parallel specs over W = 4 gloo ranks
    laid out as node 2 x data 1 x model 2 (spawned as this file's
    ``__main__`` worker): every rank's result, plain and DTensor leaves,
    bitwise the shard of the ring mix of the full params.
"""
from __future__ import annotations

import argparse
import functools
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.arch import build_arch
from repro_torch.arch.api import SHAPES
from repro_torch.arch.sharding import (P, PartitionSpec, activation_policy, constrain_act,
                                       constrain_attn, match_heads, merge_heads, param_pspecs,
                                       placements, serving_mode, shardings_for, split_heads)
from repro_torch.config import get_arch_config, list_archs
from repro_torch.core.gossip_dp import ring_mix_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, flatten_data_axes, make_gossip_dp_mesh,
                                     make_production_mesh)
from repro_torch.utils.pytree import tree_map, tree_map_with_path

HERE = Path(__file__).resolve()
ARCHS = [a for a in list_archs() if a != "glucose-lstm"]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
# one fake mode for every fake tensor of this file, so that cached trees mix
FAKE = FakeTensorMode()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to force
    512 host devices: the variable is restored after the import."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


def _abstract_mesh(multi_pod: bool):
    from jax.sharding import AbstractMesh

    return AbstractMesh(*MESHES[multi_pod])


def _entries(spec) -> tuple:
    """A spec's entries, a one-axis tuple as its axis (newer JAX
    normalises ``("data",)`` to ``"data"``; both mean the same)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _jax_specs(tree) -> dict:
    """{path: entries} of a JAX tree of PartitionSpecs (or shardings)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec, NamedSharding)))[0]
    out = {}
    for path, spec in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))) for k in path)
        out[key] = _entries(spec.spec if isinstance(spec, NamedSharding) else spec)
    return out


def _port_specs(tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(tuple(path), _entries(s)), tree,
                       is_leaf=lambda x: isinstance(x, PartitionSpec))
    return out


def _jax_params(name: str, reduced: bool = False):
    return _jax_params_cached(name, reduced)


@functools.lru_cache(maxsize=None)  # one key whether ``reduced`` is given or not
def _jax_params_cached(name: str, reduced: bool):
    import jax

    from repro.arch import build_arch as jax_build_arch
    from repro.config import get_arch_config as jax_arch_config

    cfg = jax_arch_config(name)
    arch = jax_build_arch(cfg.reduced() if reduced else cfg)
    return arch, jax.eval_shape(arch.init_params, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_serve(name: str, reduced: bool):
    """JAX's params cast to bf16, as its ``build_step`` serves them."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16),
                        _jax_params(name, reduced)[1])


@functools.lru_cache(maxsize=None)
def _jax_state(name: str, batch: int, seq: int, reduced: bool):
    """JAX's decode state of ``batch`` x ``seq`` from the bf16 params."""
    import jax

    jarch = _jax_params(name, reduced)[0]
    return jax.eval_shape(lambda p: jarch.init_decode_state(p, batch, seq),
                          _jax_serve(name, reduced))


@functools.lru_cache(maxsize=None)
def _port_params(name: str, dtype: torch.dtype):
    """The port's params as fake tensors.  The bf16 serving tree is the
    fp32 tree's shapes in bf16, which is what ``init_params(gen,
    torch.bfloat16)`` gives (every leaf in the dtype asked for; the mini
    dry runs build it so, at reduced width), without drawing it again."""
    with FAKE:
        if dtype == torch.bfloat16:
            return tree_map(lambda t: torch.empty_like(t, dtype=dtype),
                            _port_params(name, torch.float32))
        return build_arch(get_arch_config(name)).init_params(torch.Generator(), dtype)


def _cached_arch(name: str):
    """The port's Arch with ``init_params`` memoised per dtype (fake)."""
    arch = build_arch(get_arch_config(name))
    arch.init_params = lambda gen, dtype=None: _port_params(name, dtype)
    return arch


# ---------------------------------------------------------------- the rules


@pytest.mark.parametrize("name", ARCHS)
def test_param_pspecs_match_jax_at_full_width(name):
    from repro.arch.sharding import param_pspecs as jax_param_pspecs

    _, jparams = _jax_params(name)
    params = _port_params(name, torch.float32)
    rules = [dict(axis_size=16), dict(axis_size=16, fsdp_axes=("data",), fsdp_size=16),
             dict(axis_size=16, fsdp_axes=("pod", "data"), fsdp_size=32)]
    for kw in rules:
        want = _jax_specs(jax_param_pspecs(jparams, **kw))
        got = _port_specs(param_pspecs(params, **kw))
        assert got == want, (name, kw)
        assert len(got) > 3


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_decode_state_specs_match_jax(multi_pod):
    jdry = _jax_dryrun()
    amesh = _abstract_mesh(multi_pod)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        flat = flatten_data_axes(mesh)
        for name in ARCHS:
            jarch = _jax_params(name)[0]
            arch = _cached_arch(name)
            for shape, sh in SHAPES.items():
                want = _jax_specs(jdry.batch_shardings(amesh, jarch.input_specs(shape)))
                for m in (mesh, flat):
                    got = _port_specs(dryrun.batch_shardings(m, arch.input_specs(shape)))
                    assert got == want, (name, shape, multi_pod)
                if sh.kind != "decode" or not jarch.supports(shape):
                    continue
                jstate = _jax_state(name, sh.global_batch, sh.seq_len, False)
                want = _jax_specs(jdry.decode_state_shardings(amesh, jstate))
                with FAKE:
                    state = arch.init_decode_state(_port_params(name, torch.bfloat16),
                                                   sh.global_batch, sh.seq_len)
                got = _port_specs(dryrun.decode_state_shardings(mesh, state))
                assert got == want, (name, shape, multi_pod)


def jax_argument_bytes(name: str, shape: str, amesh, *, reduced: bool = False,
                       override_batch: int | None = None, override_seq: int | None = None) -> int:
    """The per-device bytes of the step's arguments under JAX's
    ``build_step`` rules, through ``NamedSharding.shard_shape`` on the
    ``AbstractMesh`` ``amesh`` (a cut batch and sequence as the port's
    ``build_step`` takes them)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.arch.sharding import data_axes as jax_data_axes
    from repro.arch.sharding import param_pspecs as jax_param_pspecs

    jdry = _jax_dryrun()
    jarch, jparams = _jax_params(name, reduced)
    sh = SHAPES[shape]
    batch_size, seq = override_batch or sh.global_batch, override_seq or sh.seq_len
    dp = jax_data_axes(amesh)
    dp_size = math.prod(amesh.shape[a] for a in dp)
    model = amesh.shape["model"]

    def nbytes(struct, spec):
        local = NamedSharding(amesh, spec).shard_shape(struct.shape)
        return math.prod(local) * jnp.dtype(struct.dtype).itemsize

    def tree_bytes(structs, specs):
        flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, (NamedSharding,)))
        return sum(nbytes(s, sp.spec) for s, sp in zip(jax.tree.leaves(structs), flat_specs))

    def param_bytes(params, pspecs):
        leaves = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return sum(nbytes(s, sp) for s, sp in zip(jax.tree.leaves(params), leaves))

    batch = jarch.input_specs(shape, override_batch=override_batch, override_seq=override_seq)
    total = tree_bytes(batch, jdry.batch_shardings(amesh, batch))
    if sh.kind == "train":
        fsdp = jarch.cfg.param_count() * 16 / model > 8e9
        kw = dict(fsdp_axes=dp, fsdp_size=dp_size) if fsdp else {}
        pspecs = jax_param_pspecs(jparams, axis_size=model, **kw)
        return total + 3 * param_bytes(jparams, pspecs) + 4  # params, m, v, int32 step
    serve = _jax_serve(name, bool(reduced))
    pspecs = jax_param_pspecs(serve, axis_size=model, fsdp_axes=dp, fsdp_size=dp_size)
    total += param_bytes(serve, pspecs)
    if sh.kind == "decode":
        state = _jax_state(name, batch_size, seq, bool(reduced))
        total += tree_bytes(state, jdry.decode_state_shardings(amesh, state))
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_bytes_match_jax_specs_for_every_combination(multi_pod):
    with fake_world(512 if multi_pod else 256):
        mesh = flatten_data_axes(make_production_mesh(multi_pod=multi_pod))
        for name in ARCHS:
            arch = _cached_arch(name)
            for shape in SHAPES:
                if not arch.supports(shape):
                    continue
                with FAKE:
                    _, args = dryrun.build_step(arch, shape, mesh)
                    got = dryrun.local_bytes(list(args))
                want = jax_argument_bytes(name, shape, _abstract_mesh(multi_pod))
                assert got == want, (name, shape, multi_pod)


# ------------------------------------------- tests/test_launch_utils.py's


def test_param_pspecs_divisibility_fallback():
    """kv-projection output (8 heads x 128) shards 16 ways via the fused
    dim; a 7-wide dim falls back to replication; stacked leaves keep a
    leading None."""
    params = {
        "wk": torch.zeros((128, 8 * 128)),
        "odd": torch.zeros((7, 13)),
        "layers": {"wq": torch.zeros((4, 128, 256))},
    }
    specs = param_pspecs(params, axis_size=16)
    assert specs["wk"] == P(None, "model")
    assert specs["odd"] == P(None, None)
    assert specs["layers"]["wq"] == P(None, None, "model")
    # the MoE's 3-D expert weights take the expert dim first
    moe = {"layers": {"moe": {"w_gate": torch.zeros((2, 32, 64, 48)),
                              "w_down": torch.zeros((2, 32, 48, 64))}}}
    assert param_pspecs(moe, axis_size=16)["layers"]["moe"]["w_gate"] == P(None, "model", None, None)
    # an expert count the axis does not divide falls back to the hidden dim
    assert param_pspecs(moe, axis_size=48)["layers"]["moe"]["w_down"] == P(None, None, "model", None)


def test_gossip_dp_ring_specs_roundtrip():
    """One node: the ring mix with shard-aware specs is the identity."""
    mesh = make_gossip_dp_mesh(nodes=1, data=1, model=1)
    params = {"w": torch.arange(12.0).reshape(3, 4)}
    out = ring_mix_params(params, mesh, ("node",), specs={"w": P(None, None)})
    torch.testing.assert_close(out["w"], params["w"], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="leaves"):
        ring_mix_params(params, mesh, ("node",), specs={"w": P(None), "b": P(None)})


def test_placements_are_pod_major_as_jax_splits():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    spec = P(("pod", "data"), None, "model")
    # rank 304 is (pod 1, data 3, model 0): JAX gives it rows 2 * (1 * 16 + 3)
    with fake_world(512, rank=304):
        mesh = make_production_mesh(multi_pod=True)
        flat = flatten_data_axes(mesh)
        assert flat.mesh_dim_names == ("pod+data", "model") and flat.shape == (32, 16)
        assert placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
        assert placements(spec, flat) == (Shard(0), Shard(2))
        assert placements(P(), flat) == (Replicate(), Replicate())
        assert shardings_for(flat, {"w": [spec, P()]}) == {
            "w": [(Shard(0), Shard(2)), (Replicate(), Replicate())]}
        for m in (mesh, flat):
            shape, offset = compute_local_shape_and_global_offset((64, 3, 32), m,
                                                                  placements(spec, m))
            assert tuple(shape) == (2, 3, 2) and tuple(offset) == (38, 0, 0)
        with pytest.raises(ValueError, match="mesh order"):
            placements(P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="split"):
            placements(P("data"), flat)
        with pytest.raises(ValueError, match="twice"):
            placements(P("model", "model"), mesh)
    with fake_world(256):
        mesh = make_production_mesh()
        assert flatten_data_axes(mesh) is mesh
        assert placements(P(("data",), "model"), mesh) == (Shard(0), Shard(1))


def test_fake_world_refuses_a_group_and_always_leaves():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="boom"):
        with fake_world(4):
            with pytest.raises(RuntimeError, match="already exists"):
                with fake_world(4):
                    pass
            raise RuntimeError("boom")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        with fake_world(4):
            make_production_mesh()
    assert not dist.is_initialized()


# ---------------------------------------------------------------- the hints


def test_hints_are_the_identity_on_plain_tensors():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 8, 12)).astype(np.float32))
    q = torch.tensor(rng.normal(size=(2, 8, 3, 4)).astype(np.float32))
    for policy in (None, ("data",)):
        if policy is None:
            outs = (constrain_act(x), constrain_attn(q, "bshd"), constrain_attn(q, "bshd", kv=True))
        else:
            with activation_policy(policy, seq_axis="model", seq_axis_size=2,
                                   attn_axis="model", attn_axis_size=2):
                outs = (constrain_act(x), constrain_attn(q, "bshd"),
                        constrain_attn(q, "bshd", kv=True))
        assert outs[0] is x and outs[1] is q and outs[2] is q
    heads = split_heads(x, 3, 4)
    assert torch.equal(heads, x.reshape(2, 8, 3, 4))
    assert heads.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    merged = merge_heads(q)
    assert torch.equal(merged, q.reshape(2, 8, 12))
    assert merge_heads(q.requires_grad_()).shape == (2, 8, 12)
    assert match_heads(q, q) is q and match_heads(x, None) is x


def test_serving_mode_is_inference_mode_on_plain_tensors():
    @serving_mode
    def double(t):
        return {"out": t * 2, "inference": torch.is_inference_mode_enabled(),
                "grad": torch.is_grad_enabled()}

    got = double(torch.ones(3))
    assert got["inference"] and not got["grad"] and torch.is_inference(got["out"])


# ----------------------------------------------- tensor-parallel ring mix


def _full_params(n: int) -> dict:
    """Node-varying params: leaf (N, ...), row n node n's."""
    rng = np.random.default_rng(7)
    return {"wq": rng.normal(size=(n, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(n, 8)).astype(np.float32),
            "scale": rng.normal(size=(n, 5)).astype(np.float32)}


RING_SPECS = {"wq": P(None, "model"), "b": P("model"), "scale": P(None)}


def _shard(leaf: np.ndarray, spec, model_idx: int, model: int) -> np.ndarray:
    for d, entry in enumerate(spec):
        if entry == "model":
            k = leaf.shape[d] // model
            leaf = np.take(leaf, np.arange(model_idx * k, (model_idx + 1) * k), axis=d)
    return leaf


def worker(argv) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, placement_types

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.world, rank=args.rank)
    torch.set_num_threads(1)
    mesh = make_gossip_dp_mesh(nodes=2, data=1, model=2, device="cpu")
    coord = dict(zip(mesh.axis_names, mesh.coords))
    node, model_idx = coord["node"], coord["model"]
    full = _full_params(2)
    local = {k: torch.tensor(_shard(v[node], RING_SPECS[k], model_idx, 2))
             for k, v in full.items()}
    plain = ring_mix_params(local, mesh, ("node",), specs=RING_SPECS)
    # the same shards as DTensors on this node's model submesh
    dmesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("node", "data", "model"))
    sub = dmesh["model"]

    def as_dtensor(k):
        spec = RING_SPECS[k]
        pl = [placement_types.Shard(spec.index("model"))] if "model" in spec else \
            [placement_types.Replicate()]
        shape = full[k].shape[1:]
        return DTensor.from_local(local[k], sub, pl, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape).stride())

    dt = ring_mix_params({k: as_dtensor(k) for k in local}, mesh, ("node",), specs=RING_SPECS)
    torch.save({"node": node, "model": model_idx, "plain": plain,
                "dtensor": {k: v.to_local() for k, v in dt.items()},
                "placements": {k: tuple(map(repr, v.placements)) for k, v in dt.items()}},
               args.out / f"rank{args.rank}.pt")
    dist.destroy_process_group()


def test_ring_mix_takes_tensor_parallel_specs_bitwise(tmp_path):
    from test_torch_distributed import spawn_ranks

    spawn_ranks(HERE, 4, tmp_path)
    full = _full_params(2)
    for r in range(4):
        row = torch.load(tmp_path / f"rank{r}.pt")
        for k, v in full.items():
            mixed = (torch.tensor(v[row["node"]]) + torch.tensor(v[1 - row["node"]])) / 2.0
            want = torch.tensor(_shard(mixed.numpy(), RING_SPECS[k], row["model"], 2))
            assert torch.equal(row["plain"][k], want), (r, k)
            assert torch.equal(row["dtensor"][k], want), (r, k)
        assert row["placements"]["wq"] == ("Shard(dim=1)",)


if __name__ == "__main__":
    worker(sys.argv[1:])
