"""Multi-pod dry run: trace every (architecture x input shape) of the LM
zoo on the production meshes at full width and depth, with no device
(a port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-large-123b --shape decode_32k

For each combination this:
  1. starts a fake world of 256 (``(16, 16)`` ``("data", "model")``) or
     512 (``(2, 16, 16)`` ``("pod", "data", "model")``) ranks in this
     process (``launch.mesh.fake_world``, where JAX forces 512 host
     devices) and builds the production ``DeviceMesh`` on it,
  2. builds the step for the shape's kind (:func:`build_step`):
       train_4k    -> the gradient-accumulated ``make_train_step``
       prefill_32k -> ``prefill_fn``
       decode_*    -> ``decode_fn`` (1 token + a seq_len-deep state),
  3. places params, state and batch as DTensors by the partition rules
     (``arch.sharding.param_pspecs``, :func:`batch_shardings`,
     :func:`decode_state_shardings`), each rank's shard a fake tensor,
  4. runs the step once on them under ``FakeTensorMode``,
     ``implicit_replication`` and ``activation_policy(data_axes(mesh))``
     (JAX's lowering context): DTensor issues the collectives that GSPMD
     would insert, on the fake group, and every op runs on the local
     shard's metadata only,
  5. records rank 0's memory (the placed arguments' bytes and
     ``MemTracker``'s peak of live storages), the FLOPs of its local ops
     (``FlopCounterMode``'s formulas) and the collective schedule.

Where JAX lowers and compiles (XLA counts a while body once: a layer
scan's or microbatch scan's cost is one trip), the port traces Python
loops: every layer and microbatch is run, and ``raw_cost.flops`` counts
them all.  ``raw_cost.bytes_accessed`` is -1 (no counterpart; JAX writes
-1 when absent).  The collectives are those DTensor issues, recorded as
``c10d_functional`` ops with their result bytes (JAX's HLO parse has no
counterpart: there is no HLO), in JAX's form ``{kind: {count, bytes,
wire_bytes}}`` plus ``total_wire_bytes``, with JAX's kind names and
wire factors.

The dry run launches no kernel: the meshes' device type is "cpu", so
a kernel wrapper of ``kernels/ops.py`` would take its plain twin, and
``gqa_attention`` sends the banded shape of a fake tensor to
``banded_flash_attention`` (JAX's function for the band, what JAX's dry
run lowers) on each rank's shards, where a CUDA mesh's shards launch
``swa_attention``.  Where the card launches the kernel (a
sliding-window prefill), the fake trace holds that function's fp32
scores of a 1,024-query block instead: the record says so
(``attention``).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import math
import time
from contextlib import contextmanager
from contextvars import ContextVar
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.arch import build_arch
from repro_torch.arch.api import SHAPES, Arch
from repro_torch.arch.common import TrainState, make_train_step
from repro_torch.arch.sharding import (P, PartitionSpec, activation_policy, axes_size, data_axes,
                                       mesh_shape, param_pspecs, placements)
from repro_torch.config import get_arch_config, list_archs
from repro_torch.launch.mesh import (fake_world, flatten_data_axes, make_production_mesh,
                                     make_test_mesh)
from repro_torch.nn import attention
from repro_torch.utils.pytree import tree_leaves, tree_map_with_path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# bytes-on-the-wire model per result byte (ring algorithms, large N limit)
_WIRE_FACTOR = {
    "all-gather": 1.0,        # result is the gathered tensor
    "all-reduce": 2.0,        # reduce-scatter + all-gather of operand size
    "reduce-scatter": 1.0,    # operand passes once (result is 1/N)
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d_functional op name -> JAX's collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

_SKIP_REASON = ("full-attention arch; long_500k requires sub-quadratic attention "
                "(DESIGN.md §4)")
_BANDED_NOTE = ("the banded branch ran {n} times as banded_flash_attention on each rank's "
                "shards: where the card launches swa_attention, this trace holds that "
                "function's fp32 scores of a 1,024-query block")

# ---------------------------------------------------------------------------
# what a rank does: its memory, its FLOPs, its collectives
# ---------------------------------------------------------------------------

_IN_PROPAGATION: ContextVar = ContextVar("in_propagation", default=False)


@contextmanager
def _propagation_outside_fake_mode():
    """Run DTensor's sharding propagation and redistribute planning
    outside the dry run's fake mode, flagged.  Propagation calls each op
    once more on tensors of the GLOBAL shape (no rank's work: under a
    fake mode of its own, which ``MemTracker`` and :class:`RankRecorder`
    skip), and a strided shard's size and offsets are read from the
    values of a small index tensor, which a fake tensor has not."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def outside(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tok = _IN_PROPAGATION.set(True)
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                _IN_PROPAGATION.reset(tok)

        return wrapper

    # (torch releases differ in which of these exist; each that does is run
    # outside the fake mode)
    patched = [(owner, name) for owner, name in (
        (ShardingPropagator, "propagate_op_sharding_non_cached"),
        (ShardingPropagator, "_propagate_tensor_meta_non_cached"),
        (_redistribute, "_gen_transform_infos_non_cached"),
        (_StridedShard, "local_shard_size_and_offset")) if hasattr(owner, name)]
    originals = [getattr(owner, name) for owner, name in patched]
    for (owner, name), fn in zip(patched, originals):
        setattr(owner, name, outside(fn))
    try:
        yield
    finally:
        for (owner, name), fn in zip(patched, originals):
            setattr(owner, name, fn)


@contextmanager
def _all_to_all_on_cpu_meshes():
    """DTensor moves a shard between tensor dims (``Shard(i)`` ->
    ``Shard(j)``) by an all-to-all, except on a "cpu" mesh, where it
    gathers the whole tensor and keeps a chunk (gloo has no all-to-all).
    The dry run's mesh is "cpu" only to route its plain twins; the fake
    group takes an all-to-all, and the card's NCCL group runs one, so
    the dry run issues the all-to-all."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


class RankMemTracker(MemTracker):
    """``MemTracker`` over rank 0's local ops only (it already lets
    DTensor desugar into local ops before it counts)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _IN_PROPAGATION.get() and not any(t is DTensor for t in types):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class RankRecorder(TorchDispatchMode):
    """The local ops' FLOPs (``FlopCounterMode``'s registry of formulas)
    and the ``c10d_functional`` collectives with their result bytes.
    DTensor ops pass through (``NotImplemented``) and are seen as the
    local ops and collectives they become."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.collectives: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _IN_PROPAGATION.get():
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        ns, name = str(packet).rsplit(".", 1) if "." in str(packet) else ("", str(packet))
        collective = "c10d_functional" in ns or ns.endswith("_dtensor")
        if collective and name in _KIND:
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.collectives.append((_KIND[name], sum(_nbytes(t) for t in outs)))
        elif "c10d_functional" in ns and name != "wait_tensor":
            raise NotImplementedError(f"collective {packet} has no kind in the schedule")
        return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_schedule(records: list[tuple[str, int]]) -> dict:
    """``{kind: {"count", "bytes", "wire_bytes"}}`` plus
    ``"total_wire_bytes"``, JAX's form and wire model, from (kind,
    result bytes) records."""
    out: dict = {}
    for kind, nbytes in records:
        rec = out.setdefault(kind, {"count": 0, "bytes": 0, "wire_bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire_bytes"] += nbytes * _WIRE_FACTOR[kind]
    out["total_wire_bytes"] = sum(
        v["wire_bytes"] for k, v in out.items() if isinstance(v, dict)
    )
    return out


def local_bytes(tree) -> int:
    """Bytes of the distinct local storages of a tree's tensors (a
    DTensor counts its rank's shard)."""
    seen, total = set(), 0
    for t in tree_leaves(_flat(tree)):
        if not isinstance(t, torch.Tensor):
            continue
        local = t.to_local() if isinstance(t, DTensor) else t
        st = local.untyped_storage()
        key = id(st) if local.device.type == "meta" else st._cdata
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _flat(tree) -> list:
    out: list = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------


def batch_shardings(mesh, batch_specs):
    """Batch-dim-on-data specs, divisibility aware."""
    dp = data_axes(mesh)
    dp_size = axes_size(mesh, dp)

    def leaf(_, spec):
        if spec.ndim == 0:
            return P()
        if spec.shape[0] % dp_size == 0 and spec.shape[0] >= dp_size:
            return P(dp, *([None] * (spec.ndim - 1)))
        return P(*([None] * spec.ndim))

    return tree_map_with_path(leaf, batch_specs)


def decode_state_shardings(mesh, state_specs):
    """Generic decode-state policy: dim0 = layer stack (replicated),
    dim1 = batch on data axes if divisible, largest remaining divisible
    dim on "model" (KV caches shard their seq dim; SSM states their
    state dim)."""
    dp = data_axes(mesh)
    dp_size = axes_size(mesh, dp)
    m_size = mesh_shape(mesh)["model"]

    def leaf(_, spec):
        nd = spec.ndim
        entries: list = [None] * nd
        if nd >= 2 and spec.shape[1] % dp_size == 0 and spec.shape[1] >= dp_size:
            entries[1] = dp
        if nd >= 3:
            dims = sorted(range(2, nd), key=lambda i: -spec.shape[i])
            for dim in dims:
                if spec.shape[dim] % m_size == 0 and spec.shape[dim] >= m_size:
                    entries[dim] = "model"
                    break
        return P(*entries)

    return tree_map_with_path(leaf, state_specs)


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """A rank's shard shape of a ``shape`` tensor placed by ``spec``
    (every sharded dim must divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        ways = axes_size(mesh, entry)
        if out[d] % ways:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {ways} ways ({spec})")
        out[d] //= ways
    return tuple(out)


def place(t: torch.Tensor, spec: PartitionSpec, mesh) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype placed by ``spec``,
    whose local shard is a new (uninitialised) tensor: under
    ``FakeTensorMode`` a fake one, so nothing is allocated."""
    shape = tuple(t.shape)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=t.dtype)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _place_tree(tree, specs, mesh):
    flat_specs = []
    tree_map_with_path(lambda _, s: flat_specs.append(s), specs,
                       is_leaf=lambda x: isinstance(x, PartitionSpec))
    it = iter(flat_specs)
    return tree_map_with_path(lambda _, t: place(t, next(it), mesh), tree)


def _microbatches(global_batch: int, dp_size: int, num_microbatches: int) -> int:
    """Rows per microbatch must stay divisible by the data-axis size."""
    mb = min(num_microbatches, max(global_batch // dp_size, 1))
    while global_batch % mb:
        mb //= 2
    return mb


def build_step(arch: Arch, shape_name: str, mesh, *, num_microbatches: int = 16,
               override_batch: int | None = None, override_seq: int | None = None):
    """Returns ``(fn, args)``: the step and its arguments as DTensors
    placed by the partition rules, each rank's shard a fake tensor.  Call
    it under ``FakeTensorMode``.  ``override_batch`` / ``override_seq``
    cut the shape's batch and sequence (``Arch.input_specs``); the
    microbatch rule reads the cut batch."""
    cfg = arch.cfg
    sh = SHAPES[shape_name]
    model = mesh_shape(mesh)["model"]
    dp = data_axes(mesh)
    dp_size = axes_size(mesh, dp)
    batch = override_batch or sh.global_batch
    if sh.kind == "train":
        # ZeRO/FSDP: when params+adam (16 bytes/param) exceed the HBM
        # budget under pure tensor parallelism, additionally shard the
        # train state over the data axes
        params = arch.init_params(torch.Generator(), torch.float32)
        if cfg.param_count() * 16 / model > 8e9:
            pspecs = param_pspecs(params, axis_size=model, fsdp_axes=dp, fsdp_size=dp_size)
        else:
            pspecs = param_pspecs(params, axis_size=model)
    else:
        # serving: bf16 weights + FSDP over the data axes
        params = arch.init_params(torch.Generator(), torch.bfloat16)
        pspecs = param_pspecs(params, axis_size=model, fsdp_axes=dp, fsdp_size=dp_size)
    batch_specs = arch.input_specs(shape_name, override_batch=override_batch,
                                   override_seq=override_seq)
    placed_batch = _place_tree(batch_specs, batch_shardings(mesh, batch_specs), mesh)
    placed_params = _place_tree(params, pspecs, mesh)

    if sh.kind == "train":
        mb = _microbatches(batch, dp_size, num_microbatches)
        step = make_train_step(arch.loss_fn, num_microbatches=mb, lr=1e-4, data_axes=dp)
        zeros = tree_map_with_path(lambda _, t: torch.zeros_like(t), placed_params)
        state = TrainState(params=placed_params, m=zeros,
                           v=tree_map_with_path(lambda _, t: torch.zeros_like(t), placed_params),
                           step=place(torch.empty((), dtype=torch.int32), P(), mesh))
        return step, (state, placed_batch)

    if sh.kind == "prefill":
        return arch.prefill_fn, (placed_params, placed_batch)

    state = arch.init_decode_state(params, batch, override_seq or sh.seq_len)
    placed_state = _place_tree(state, decode_state_shardings(mesh, state), mesh)
    return arch.decode_fn, (placed_params, placed_state, placed_batch)


# ---------------------------------------------------------------------------
# dry run per combination
# ---------------------------------------------------------------------------


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` once on placed fake arguments and return rank
    0's memory, FLOPs and collectives."""
    arg_bytes = local_bytes(list(args))
    tracker, recorder = RankMemTracker(), RankRecorder()
    tracker.track_external(*[t for t in tree_leaves(_flat(list(args)))
                             if isinstance(t, torch.Tensor)])
    with _propagation_outside_fake_mode(), _all_to_all_on_cpu_meshes(), tracker, recorder, implicit_replication():
        out = fn(*args)
    peak = max((snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values()),
               default=0)
    # outputs that are new storages (not an argument's)
    out_bytes = local_bytes([list(args), out]) - arg_bytes
    return {"memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                       "temp_bytes": max(peak - arg_bytes - out_bytes, 0),
                       "total_per_device_bytes": peak},
            "flops": recorder.flops, "collectives": collective_schedule(recorder.collectives)}


def dryrun_one(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               num_microbatches: int = 16, save: bool = True, verbose: bool = True,
               reduced: bool = False, test_mesh: int | None = None,
               override_batch: int | None = None, override_seq: int | None = None,
               out_dir: Path | None = None) -> dict:
    """One combination's record (JAX's keys).  ``reduced`` takes the
    config's ``.reduced()``; ``test_mesh`` W runs on ``make_test_mesh``
    of a fake world of W ranks in place of the production mesh."""
    cfg = get_arch_config(arch_name)
    cfg = cfg.reduced() if reduced else cfg
    arch = build_arch(cfg)
    world = test_mesh or (512 if multi_pod else 256)
    mesh_name = f"test{test_mesh}" if test_mesh else ("pod2x16x16" if multi_pod else "pod16x16")
    rec: dict = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "family": cfg.family, "status": "skipped",
    }
    if not arch.supports(shape_name):
        rec["reason"] = _SKIP_REASON
        if verbose:
            print(f"[{arch_name} | {shape_name} | {mesh_name}] skipped: {_SKIP_REASON}", flush=True)
        if save:
            _save(rec, out_dir)
        return rec

    banded = attention.BRANCHES["banded"]
    with fake_world(world):
        # the mesh holds a real tensor of its ranks: built before the fake mode
        mesh = (make_test_mesh(test_mesh) if test_mesh
                else flatten_data_axes(make_production_mesh(multi_pod=multi_pod)))
        t0 = time.time()
        with FakeTensorMode(), activation_policy(data_axes(mesh)):
            fn, args = build_step(arch, shape_name, mesh, num_microbatches=num_microbatches,
                                  override_batch=override_batch, override_seq=override_seq)
            t_lower = time.time() - t0
            t0 = time.time()
            traced = trace_step(fn, args)
            t_compile = time.time() - t0
    rec.update(
        status="ok",
        devices=world,
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        memory=traced["memory"],
        raw_cost={  # rank 0's, every layer and microbatch counted (module doc)
            "flops": float(traced["flops"]),
            "bytes_accessed": -1.0,
        },
        collectives=traced["collectives"],
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
    )
    banded = attention.BRANCHES["banded"] - banded
    if banded:
        rec["attention"] = _BANDED_NOTE.format(n=banded)
    total = rec["memory"]["total_per_device_bytes"]
    if torch.cuda.is_available():
        rec["fit"] = total / torch.cuda.get_device_properties(0).total_memory
    if verbose:
        fit = f" ({rec['fit'] * 100:.0f}% of the card)" if "fit" in rec else ""
        counts = {k: v["count"] for k, v in rec["collectives"].items() if isinstance(v, dict)}
        print(f"[{arch_name} | {shape_name} | {mesh_name}] OK "
              f"trace={t_compile:.1f}s args/rank={rec['memory']['argument_bytes'] / 1e9:.3f}GB "
              f"peak/rank={total / 1e9:.3f}GB{fit} collectives={counts}", flush=True)
    if save:
        _save(rec, out_dir)
    return rec


def _save(rec: dict, out_dir: Path | None = None):
    out = out_dir or OUT_DIR
    out.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out / name).write_text(json.dumps(rec, indent=2))


def _run_one(arch: str, shape: str, multi_pod: bool, kw: dict):
    """(record, None) or (None, the error), reported as it happens."""
    # DTensor warns at every redistribution that takes two collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    try:
        return dryrun_one(arch, shape, multi_pod=multi_pod, **kw), None
    except Exception as e:  # noqa: BLE001 — report and continue
        print(f"[{arch} | {shape} | multi_pod={multi_pod}] FAILED: {type(e).__name__}: {e}",
              flush=True)
        return None, f"{type(e).__name__}: {e}"


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", action="append", choices=list(SHAPES),
                    help="input shape (repeat for several; default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", help="the configs' reduced variants")
    ap.add_argument("--test-mesh", type=int, default=None, metavar="W",
                    help="make_test_mesh over a fake world of W ranks instead")
    ap.add_argument("--batch", type=int, default=None, help="cut the shapes' global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the shapes' sequence")
    ap.add_argument("--out-dir", type=Path, default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [a for a in list_archs() if a != "glucose-lstm"]
    shapes = args.shape or list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(arch, shape, mp) for arch in archs for shape in shapes for mp in meshes]
    kw = dict(num_microbatches=args.microbatches, reduced=args.reduced, test_mesh=args.test_mesh,
              override_batch=args.batch, override_seq=args.seq, out_dir=args.out_dir)

    records, failures = [], []
    t_all = time.time()
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx, initializer=torch.set_num_threads,
                                 initargs=(1,)) as pool:
            # the train steps, the longest traces, first
            order = sorted(combos, key=lambda c: SHAPES[c[1]].kind != "train")
            futures = {c: pool.submit(_run_one, *c, kw) for c in order}
            results = [futures[c].result() for c in combos]
    else:
        results = [_run_one(arch, shape, mp, kw) for arch, shape, mp in combos]
    for (arch, shape, mp), (rec, err) in zip(combos, results):
        if err is None:
            records.append(rec)
        else:
            failures.append((arch, shape, mp, err[:200]))
    print(f"\n{len(records)} records in {time.time() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS OK")
    return records


if __name__ == "__main__":
    main()
