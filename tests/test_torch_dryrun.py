"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) on the CPU.

  * The mini dry run, the counterpart of
    ``tests/test_distributed.py::test_mini_dryrun_dense_and_moe`` (held
    against JAX's functions, not against that test): on a fake (4, 2)
    ``("data", "model")`` mesh, reduced yi-6b, granite-moe-1b-a400m and
    mamba2-370m trace the train step at M=2 (batch 8, seq 32), and one
    reduced config of each family one serving step (a prefill, or a
    decode where the numbers test below runs no decode of the family):
    status ok, FLOPs counted, the per-rank argument bytes those of
    JAX's specs on an ``AbstractMesh`` of the same shape, no process
    group left.
  * The collective schedule on a hand-derived case: two dense layers,
    column- then row-parallel on "model", whose partial sums one
    all-reduce resolves; the memory and FLOP counts of the same trace.
  * Numbers through DTensor: in W = 4 gloo ranks laid out as data 2 x
    model 2 (spawned as this file's ``__main__`` worker), a reduced
    Granite-MoE prefill and one train step (M=2) with real tensors
    placed by the partition rules (the MoE's per-row combine, the masked
    label pick and the head splits on their DTensor paths), and reduced
    Mamba2 and RecurrentGemma prefills (the SSD and the RG-LRU scan on
    each rank's shards), against the one-process runs from the same
    params and batch: within 1e-5 (the collectives sum in another
    order).
    Then three decode steps of reduced Granite-MoE (a 64-slot KV cache
    whose slots are split over "model", holding a 30-token prefill, so
    that the steps write slots 30-32 across the two halves), Mamba2 (the
    SSD state) and Whisper (the cross K/V of random frames, split on
    their head dim), each state placed by ``decode_state_shardings``:
    every step's logits and the last state within 1e-5 of one process.
    And ``gqa_attention``'s banded shape on q, k, v sharded on batch and
    heads: ``swa_attention``'s wrapper called once a rank on its local
    tensors (the kernel on a CUDA mesh, the twin here), the result
    within 1e-5 of the twin on the whole tensors.
  * The CLI on one reduced combination.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.arch import build_arch
from repro_torch.arch.common import TrainState, init_train_state, make_train_step
from repro_torch.arch.sharding import (P, PartitionSpec, activation_policy, data_axes,
                                       param_pspecs, placements)
from repro_torch.config import get_arch_config
from repro_torch.kernels.ref import swa_attention_plain
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_map_with_path

HERE = Path(__file__).resolve()
MINI = dict(override_batch=8, override_seq=32)
TRAIN_ARCHS = ("yi-6b", "granite-moe-1b-a400m", "mamba2-370m")
# one reduced config a family and one serving step each: dense, MoE, VLM,
# SSM, hybrid, enc-dec (the decodes that these prefills leave out run
# with values through DTensor in the numbers test)
SERVE = (("yi-6b", "decode_32k"), ("granite-moe-1b-a400m", "prefill_32k"),
         ("llava-next-mistral-7b", "prefill_32k"), ("mamba2-370m", "prefill_32k"),
         ("recurrentgemma-9b", "decode_32k"), ("whisper-medium", "prefill_32k"))
NUMBERS_ARCH = "granite-moe-1b-a400m"
# prefills only: the SSD and the RG-LRU scan on each rank's shards
NUMBERS_PREFILLS = ("mamba2-370m", "recurrentgemma-9b")
NUMBERS_TOL = 1e-5
NUMBERS_LR = 1e-3
# decode through DTensor: the KV cache (MoE), the SSD state, the cross K/V
DECODE_ARCHS = ("granite-moe-1b-a400m", "mamba2-370m", "whisper-medium")
DECODE_SLOTS, DECODE_PREFIX, DECODE_STEPS = 64, 30, 3
# the banded shape at a small size: S > flash_threshold, band_span 32 < S
BANDED = dict(b=4, s=64, h=4, kh=2, hd=8, window=16, flash_threshold=32, block=16)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract_mesh():
    from jax.sharding import AbstractMesh

    return AbstractMesh((4, 2), ("data", "model"))


@pytest.mark.parametrize("name,shape", [(n, "train_4k") for n in TRAIN_ARCHS] + list(SERVE))
def test_mini_dry_run_matches_jax_specs(name, shape):
    from test_torch_sharding import jax_argument_bytes

    rec = dryrun.dryrun_one(name, shape, reduced=True, test_mesh=8, num_microbatches=2,
                            save=False, verbose=False, **MINI)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["devices"] == 8 and rec["mesh"] == "test8"
    assert rec["raw_cost"]["flops"] > 0 and rec["raw_cost"]["bytes_accessed"] == -1.0
    mem = rec["memory"]
    assert mem["total_per_device_bytes"] >= mem["argument_bytes"] + mem["output_bytes"] > 0
    want = jax_argument_bytes(name, shape, _abstract_mesh(), reduced=True, **MINI)
    assert mem["argument_bytes"] == want
    assert set(rec) >= {"arch", "shape", "mesh", "family", "status", "lower_s", "compile_s",
                        "memory", "raw_cost", "collectives", "params", "active_params"}


def test_two_dense_layers_take_the_hand_derived_collectives():
    """x (B, d) batch-sharded, w1 (d, f) split on "model" by columns, w2
    (f, d) by rows: no collective until the partial sums are pinned to
    a replica on "model", one all-reduce of the (B/4, d) fp32 output."""
    b, d, f = 16, 32, 64
    with fake_world(8):
        mesh = make_test_mesh(8)
        with FakeTensorMode():
            x = dryrun.place(torch.empty(b, d), dryrun.P("data", None), mesh)
            w1 = dryrun.place(torch.empty(d, f), dryrun.P(None, "model"), mesh)
            w2 = dryrun.place(torch.empty(f, d), dryrun.P("model", None), mesh)

            def two_dense(x, w1, w2):
                y = (x @ w1) @ w2
                return y.redistribute(mesh, placements(dryrun.P("data", None), mesh))

            traced = dryrun.trace_step(two_dense, (x, w1, w2))
    assert not dist.is_initialized()
    out_bytes = b // 4 * d * 4
    assert traced["collectives"] == {
        "all-reduce": {"count": 1, "bytes": out_bytes, "wire_bytes": 2.0 * out_bytes},
        "total_wire_bytes": 2.0 * out_bytes}
    assert traced["flops"] == 2 * (b // 4) * d * (f // 2) + 2 * (b // 4) * (f // 2) * d
    assert traced["memory"]["argument_bytes"] == 4 * (b // 4 * d + d * f // 2 + f // 2 * d)
    # the local product (B/4, f/2) and the reduced output are live at the peak
    assert traced["memory"]["total_per_device_bytes"] >= (
        traced["memory"]["argument_bytes"] + out_bytes)


def test_cli_runs_one_reduced_combination(tmp_path, capsys):
    records = dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--reduced",
                           "--test-mesh", "8", "--batch", "8", "--seq", "32",
                           "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "ALL DRY-RUNS OK" in out and "[yi-6b | decode_32k | test8] OK" in out
    assert [r["status"] for r in records] == ["ok"]
    saved = sorted(p.name for p in tmp_path.glob("*.json"))
    assert saved == ["yi-6b__decode_32k__test8.json"]
    assert not dist.is_initialized()


# ------------------------------------------------- numbers through DTensor


def _numbers_setup(name: str = NUMBERS_ARCH):
    cfg = dataclasses.replace(get_arch_config(name).reduced(), dtype="float32")
    arch = build_arch(cfg)
    params = arch.init_params(torch.Generator().manual_seed(27), torch.float32)
    rng = np.random.default_rng(27)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, size=(8, 32)), dtype=torch.int32)
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, size=(8, 32)), dtype=torch.int32)
    return cfg, arch, params, {"tokens": tokens}, {"tokens": tokens, "labels": labels}


def _leaves(tree) -> list:
    """The leaves of a tree that may hold dataclasses (``KVCache``), in
    ``tree_map_with_path``'s order."""
    out: list = []
    tree_map_with_path(lambda _, t: out.append(t), tree,
                       is_leaf=lambda x: isinstance(x, PartitionSpec))
    return out


def _decode_setup(name: str):
    """A reduced config's params, decode state and DECODE_STEPS token
    batches: Granite-MoE's KV cache of DECODE_SLOTS slots holding a
    DECODE_PREFIX-token prefill, Mamba2's zero state, Whisper's state
    with the cross K/V of random frames."""
    from repro_torch.arch import encdec
    from repro_torch.nn.attention import KVCache

    cfg, arch, params, prompt, _ = _numbers_setup(name)
    rng = np.random.default_rng(28)
    if cfg.family == "encdec":
        frames = torch.tensor(rng.normal(size=(8, cfg.encoder_seq, cfg.d_model)),
                              dtype=torch.float32)
        state = encdec.init_state(params, cfg, 8, DECODE_SLOTS, frames=frames)
    else:
        state = arch.init_decode_state(params, 8, DECODE_SLOTS)
    state = tree_map_with_path(lambda _, t: t.clone(), state)  # no inference tensors
    if isinstance(state, KVCache):
        _, caches = arch.prefill_fn(params, {"tokens": prompt["tokens"][:, :DECODE_PREFIX]})
        state.k[:, :, :DECODE_PREFIX] = caches.k
        state.v[:, :, :DECODE_PREFIX] = caches.v
        state.pos.copy_(caches.pos)
    steps = [{"token": torch.tensor(rng.integers(0, cfg.vocab_size, size=(8, 1)),
                                    dtype=torch.int32),
              "pos": torch.tensor(DECODE_PREFIX + i, dtype=torch.int32)}
             for i in range(DECODE_STEPS)]
    return arch, params, state, steps


def _decode(arch, params, state, steps):
    """Every step's logits and the last state, whole tensors."""
    full = (lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t)
    logits = []
    for batch in steps:
        out, state = arch.decode_fn(params, state, batch)
        logits.append(full(out))
    return logits, tree_map_with_path(lambda _, t: full(t), state)


def _banded_inputs():
    c = BANDED
    rng = np.random.default_rng(29)
    return tuple(torch.tensor(rng.normal(size=shape), dtype=torch.float32)
                 for shape in ((c["b"], c["s"], c["h"], c["hd"]),
                               (c["b"], c["s"], c["kh"], c["hd"]),
                               (c["b"], c["s"], c["kh"], c["hd"])))


def _step_summary(new: TrainState, metrics: dict) -> dict:
    full = (lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t)
    return {"loss": full(metrics["loss"]).detach(), "grad_norm": full(metrics["grad_norm"]),
            "params": [full(p).detach() for p in tree_leaves(new.params)],
            "m": [full(m) for m in tree_leaves(new.m)]}


def worker(argv) -> None:
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.nn import attention

    swa_attention = ops.swa_attention

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.world, rank=args.rank)
    torch.set_num_threads(1)
    mesh = make_test_mesh(4)
    cfg, arch, params, prompt, batch = _numbers_setup()

    def place_tree(tree, specs):
        return tree_map(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh),
                                                          src_data_rank=None), tree, specs)

    def place_state(state, specs):
        flat = iter(_leaves(specs))
        return tree_map_with_path(lambda _, t: place_tree(t, next(flat)), state)

    pspecs = param_pspecs(params, axis_size=2)
    with activation_policy(data_axes(mesh)), implicit_replication():
        served = place_tree(tree_map(lambda t: t.detach().clone(), params), pspecs)
        logits, _ = arch.prefill_fn(served, place_tree(prompt, dryrun.batch_shardings(mesh, prompt)))
        state = init_train_state(place_tree(params, pspecs))
        step = make_train_step(arch.loss_fn, num_microbatches=2, lr=NUMBERS_LR,
                               data_axes=data_axes(mesh))
        new, metrics = step(state, place_tree(batch, dryrun.batch_shardings(mesh, batch)))
        out = {"logits": logits.full_tensor(), **_step_summary(new, metrics)}
        for name in NUMBERS_PREFILLS:
            _, other, p, prompt, _ = _numbers_setup(name)
            logits, _ = other.prefill_fn(place_tree(p, param_pspecs(p, axis_size=2)),
                                         place_tree(prompt, dryrun.batch_shardings(mesh, prompt)))
            out[name] = logits.full_tensor()
        for name in DECODE_ARCHS:
            other, p, state, steps = _decode_setup(name)
            out[f"{name}/decode"] = _decode(
                other, place_tree(p, param_pspecs(p, axis_size=2)),
                place_state(state, dryrun.decode_state_shardings(mesh, state)),
                [place_tree(b, dryrun.batch_shardings(mesh, b)) for b in steps])
        # the banded shape on batch and head shards: the wrapper sees local tensors
        seen = []

        def spy(q, k, v, *, window):
            seen.append((type(q).__name__, tuple(q.shape), tuple(k.shape)))
            return swa_attention(q, k, v, window=window)

        spec = P("data", None, "model", None)
        q, k, v = (place_tree(t, spec) for t in _banded_inputs())
        banded = attention.BRANCHES["banded"]
        ops.swa_attention = spy
        try:
            got = attention.gqa_attention(q, k, v, window=BANDED["window"],
                                          flash_threshold=BANDED["flash_threshold"],
                                          block=BANDED["block"])
        finally:
            ops.swa_attention = swa_attention
        out["banded"] = {"out": got.full_tensor(), "seen": seen,
                         "branches": attention.BRANCHES["banded"] - banded,
                         "placements": tuple(map(repr, got.placements))}
    torch.save(out, args.out / f"rank{args.rank}.pt")
    dist.destroy_process_group()


def _one_process():
    """The one-process results that the ranks are held against."""
    _, arch, params, prompt, batch = _numbers_setup()
    want_logits, _ = arch.prefill_fn(params, prompt)
    step = make_train_step(arch.loss_fn, num_microbatches=2, lr=NUMBERS_LR)
    new, metrics = step(init_train_state(params), batch)
    prefills = {}
    for name in NUMBERS_PREFILLS:
        _, other, p, prompt, _ = _numbers_setup(name)
        prefills[name] = other.prefill_fn(p, prompt)[0]
    decodes = {name: _decode(*_decode_setup(name)) for name in DECODE_ARCHS}
    banded = swa_attention_plain(*_banded_inputs(), window=BANDED["window"])
    return want_logits, _step_summary(new, metrics), prefills, decodes, banded


@pytest.fixture(scope="module")
def dtensor_ranks(tmp_path_factory):
    """The W = 4 gloo ranks' results (one dict a rank) and the
    one-process results, computed beside them in a thread."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_distributed import spawn_ranks

    out = tmp_path_factory.mktemp("dtensor_ranks")
    with ThreadPoolExecutor(1) as pool:
        one = pool.submit(_one_process)
        spawn_ranks(HERE, 4, out)
        want = one.result()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)], want


def _close(a, b) -> bool:
    return float((a - b).abs().max()) <= NUMBERS_TOL * max(float(b.abs().max()), 1e-30)


def test_numbers_through_dtensor_match_one_process(dtensor_ranks):
    ranks, (want_logits, want, prefills, _, _) = dtensor_ranks
    grads = [m / 0.1 for m in want["m"]]  # Adam's first moment after one step is 0.1 g
    for got in ranks:
        scale = float(want_logits.abs().max())
        assert float((got["logits"] - want_logits).abs().max()) <= NUMBERS_TOL * scale
        for name, want_other in prefills.items():
            err = float((got[name] - want_other).abs().max())
            assert err <= NUMBERS_TOL * float(want_other.abs().max()), (name, err)
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= NUMBERS_TOL * abs(float(want[key]))
        for a, b in zip(got["m"], want["m"]):
            assert float((a - b).abs().max()) <= NUMBERS_TOL * max(float(b.abs().max()), 1e-30)
        for a, b, g in zip(got["params"], want["params"], grads):
            err, signal = (a - b).abs(), g.abs() > 1e-6
            if bool(signal.any()):
                assert float(err[signal].max()) <= NUMBERS_LR * 1e-3
            assert float(err.max()) <= 2 * NUMBERS_LR


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_through_dtensor_matches_one_process(dtensor_ranks, name):
    ranks, (_, _, _, decodes, _) = dtensor_ranks
    want_logits, want_state = decodes[name]
    for got in ranks:
        got_logits, got_state = got[f"{name}/decode"]
        assert len(got_logits) == DECODE_STEPS
        for i, (a, b) in enumerate(zip(got_logits, want_logits)):
            assert _close(a, b), (name, i)
        for a, b in zip(_leaves(got_state), _leaves(want_state), strict=True):
            assert a.shape == b.shape and _close(a.float(), b.float()), name


def test_banded_shape_on_dtensors_runs_the_wrapper_on_local_shards(dtensor_ranks):
    ranks, (_, _, _, _, banded) = dtensor_ranks
    for got in ranks:
        # data 2 x model 2: each rank's 2 batch rows and 2 heads, K/V repeated to them
        assert got["banded"]["branches"] == 1
        assert got["banded"]["seen"] == [("Tensor", (2, 64, 2, 8), (2, 64, 2, 8))]
        assert got["banded"]["placements"] == ("Shard(dim=0)", "Shard(dim=2)")
        assert _close(got["banded"]["out"], banded)


if __name__ == "__main__":
    worker(sys.argv[1:])
