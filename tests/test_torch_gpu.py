"""The port's CUDA kernels on the card: ``lstm_forward``, the four
gossip kernels and ``swa_attention`` held against their plain twins, a
row's result bitwise independent of the launch it shares, the staged
gossip kernels bitwise the row-wise kernel they replace, the wrappers'
refusals, the servable's bitwise contract through ``lstm_forward`` (a
personalized cohort's rows too), a few training rounds through the
gossip kernels (masked rounds bitwise unmasked ones), a sweep's G-group
eval through one ``lstm_forward`` launch and a small sweep on the card
against the same sweep on the CPU, a streaming ``eval_fn`` on the card
against the CPU and Fig 4's eval launches, the baselines (FedAvg and
MAML/MetaSGD on the card against the CPU from one set of draws, the
Table-4 evaluation through ``lstm_forward``, at REPLACE-BG's pooled
R=71,317 val windows too), and the banded branch of ``gqa_attention``
and a small LM prefill through ``swa_attention``.

These tests need a CUDA device and skip elsewhere (decided inside the
``cuda`` fixture).  They import neither ``jax`` nor ``repro``, so they
run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import FLConfig
from repro_torch.core import MAML, FedAvg, GluADFL, MetaSGD, train_supervised
from repro_torch.core.topology import mixing_matrix, neighbor_table, random_adjacency
from repro_torch.kernels import gossip_mix as gossip_kernels
from repro_torch.kernels import lstm_cell, ref
from repro_torch.kernels import swa_attention as swa_kernel
from repro_torch.kernels.ref import lstm_forward_plain
from repro_torch.optim import adam, get_optimizer
from repro_torch.launch.serve import selfcheck
from repro_torch.models import LSTMModel
from repro_torch.serve import GlucoseServable, MicroBatcher, Request, replay

pytestmark = pytest.mark.gpu

ATOL = 1e-5  # fp32 summation order over 12 recurrent steps
# gossip: fp32 sums of <= B+1 = 8 row-stochastic weights times values
# ~1, kernel (FMA) against twin (multiply, then add)
GOSSIP_ATOL = 1e-6
L = 12
# swa_attention against its twin, JAX's own tolerances for the Pallas
# kernel (tests/test_kernels.py): fp32 sums over <= 4096 keys in another
# order; bf16 inputs, the output rounded to bf16 (and the kernel's P; its
# bf16 results are also held elementwise to ref.swa_bf16_bound)
SWA_ATOL = {torch.float32: 3e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _forward_inputs(g, r, steps, isz, hsz, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(g, r, steps, isz)),
        rng.normal(size=(g, isz, 4 * hsz)) / np.sqrt(isz),
        rng.normal(size=(g, hsz, 4 * hsz)) / np.sqrt(hsz),
        rng.normal(size=(g, 4 * hsz)),
        rng.normal(size=(g, hsz, 1)) / np.sqrt(hsz),
        rng.normal(size=(g, 1)),
    )
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays)


# the kernel's paths (lstm_cell._plan, pure): the largest H a cluster of
# 8 holds, and the first H that streams
_C8_MAX = max(h for h in range(1, lstm_cell.MAX_HIDDEN + 1)
              if lstm_cell._plan(1, 1, L, 1, h).cluster == 8)
_STREAMED = _C8_MAX + 1


@pytest.mark.parametrize("g,r,steps,isz,hsz", [
    (1, 1, 12, 1, 8), (37, 1, 12, 1, 32), (64, 1, 12, 1, 128), (5, 3, 1, 3, 16),
    # each cluster size's regime (C = 1; 2 in registers; 2, 4, 8 by TMA; 8 by
    # cp.async; streamed), ragged G
    # and a ragged last row tile (R = TILE + 1)
    (37, 9, 12, 1, 8), (37, 9, 12, 1, 128), (3, 9, 12, 1, 144), (3, 9, 12, 1, 192),
    (3, 9, 12, 1, 256), (2, 9, 12, 1, _C8_MAX), (2, 3, 12, 1, _STREAMED),
    # L = 1 and I = 3 on the TMA and the cp.async loads and in registers
    (4, 9, 1, 3, 32), (4, 9, 1, 3, 30), (3, 2, 1, 3, 128)])
def test_kernel_matches_plain(cuda, g, r, steps, isz, hsz):
    args = _forward_inputs(g, r, steps, isz, hsz, seed=g, device=cuda)
    before = lstm_cell.LAUNCHES
    got = lstm_cell.lstm_forward(*args)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES == before + 1
    torch.testing.assert_close(got, lstm_forward_plain(*args), rtol=0, atol=ATOL)


def test_kernel_row_is_bitwise_independent_of_batch(cuda):
    args = _forward_inputs(16, 1, L, 1, 128, seed=6, device=cuda)
    full = lstm_cell.lstm_forward(*args)
    for i in (0, 5, 15):
        one = lstm_cell.lstm_forward(*(a[i : i + 1] for a in args))
        assert torch.equal(one[0], full[i])


@pytest.mark.parametrize("hsz", [128, 64, 30])
def test_kernel_row_tile_is_bitwise_independent_of_batch(cuda, hsz):
    """Rows of R > 1 launches (tiles of TILE rows, the last one ragged)
    bitwise their own R=1 launches, in registers, TMA and cp.async."""
    g, r = 3, 2 * lstm_cell.TILE + 3
    args = _forward_inputs(g, r, L, 1, hsz, seed=hsz, device=cuda)
    full = lstm_cell.lstm_forward(*args)
    for gi in (0, 2):
        for ri in (0, lstm_cell.TILE - 1, lstm_cell.TILE, r - 1):
            one = lstm_cell.lstm_forward(args[0][gi : gi + 1, ri : ri + 1].contiguous(),
                                         *(a[gi : gi + 1] for a in args[1:]))
            assert torch.equal(one[0, 0], full[gi, ri]), (gi, ri)


def test_kernel_refuses_a_cluster_that_cannot_be_scheduled(cuda, monkeypatch):
    """A plan the card cannot schedule (a cluster of 16, beyond the
    portable 8) raises before anything is launched, and no other path
    takes over."""
    args = _forward_inputs(2, 1, L, 1, 8, seed=9, device=cuda)
    plan = lstm_cell._plan(2, 1, L, 1, 8)
    monkeypatch.setattr(lstm_cell, "_plan", lambda *shape: plan._replace(cluster=16))
    before = lstm_cell.LAUNCHES
    with pytest.raises(RuntimeError, match="lstm_forward"):
        lstm_cell.lstm_forward(*args)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES == before


def test_kernel_wrapper_checks_shape_dtype_contiguity(cuda):
    args = list(_forward_inputs(2, 1, L, 1, 8, seed=8, device=cuda))
    before = lstm_cell.LAUNCHES
    with pytest.raises(ValueError, match="wh must be"):
        lstm_cell.lstm_forward(*args[:2], args[2][:, :, :16].contiguous(), *args[3:])
    with pytest.raises(TypeError, match="float32"):
        lstm_cell.lstm_forward(args[0].double(), *args[1:])
    strided = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell.lstm_forward(*args[:2], strided, *args[3:])
    assert lstm_cell.LAUNCHES == before


def test_served_equals_direct_apply_through_the_kernel(cuda):
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16))
    windows = np.random.default_rng(6).normal(size=(37, L)).astype(np.float32)
    reqs = [Request(rid=i, patient=0, window=w) for i, w in enumerate(windows)]
    before = lstm_cell.LAUNCHES
    preds = replay(sv, MicroBatcher(sv.buckets), reqs)
    assert lstm_cell.LAUNCHES > before
    assert selfcheck(sv, reqs, preds) == 0


def _gossip_case(n, d, ratio, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((n, d), generator=gen, device=device)
    z = 0.01 * torch.randn((n, d), generator=gen, device=device)
    act = (torch.rand(n, generator=gen, device=device) >= ratio).float()
    scores = torch.rand((n, n), generator=gen, device=device)
    adj = random_adjacency(scores, min(7, n - 1)) if n > 1 else torch.zeros((1, 1), device=device)
    mix = mixing_matrix(adj, act, 7)
    idx, wgt = neighbor_table(adj, act, 7)
    return w, z, act, mix, idx, wgt


def _gossip_calls(w, z, act, mix, idx, wgt):
    return [
        ("gossip_mix", gossip_kernels.gossip_mix, ref.gossip_mix_plain, (mix, w, act)),
        ("gossip_mix_sparse", gossip_kernels.gossip_mix_sparse, ref.gossip_mix_sparse_plain,
         (idx, wgt, w, act)),
        ("gossip_mix_dp", gossip_kernels.gossip_mix_dp, ref.gossip_mix_dp_plain, (mix, w, z, act)),
        ("gossip_mix_sparse_dp", gossip_kernels.gossip_mix_sparse_dp,
         ref.gossip_mix_sparse_dp_plain, (idx, wgt, w, z, act)),
    ]


@pytest.mark.parametrize("n,d", [(1, 1), (12, 513), (37, 66689), (226, 4099)])
@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
def test_gossip_kernels_match_plain(cuda, n, d, ratio):
    w, z, act, mix, idx, wgt = _gossip_case(n, d, ratio, seed=n + d, device=cuda)
    inactive = act == 0
    for name, kernel, plain, args in _gossip_calls(w, z, act, mix, idx, wgt):
        before = gossip_kernels.LAUNCHES[name]
        got = kernel(*args)
        again = kernel(*args)
        torch.cuda.synchronize()
        assert gossip_kernels.LAUNCHES[name] == before + 2
        torch.testing.assert_close(got, plain(*args), rtol=0, atol=GOSSIP_ATOL)
        assert torch.equal(got, again), name
        assert torch.equal(got[inactive], w[inactive]), name


def _rowwise_pairs(w, z, act, mix, idx, wgt):
    """(name, staged-or-planned wrapper, row-wise wrapper, args) for the
    three kernels with a staged design."""
    return [
        ("gossip_mix", gossip_kernels.gossip_mix, gossip_kernels.gossip_mix_rowwise,
         (mix, w, act)),
        ("gossip_mix_dp", gossip_kernels.gossip_mix_dp, gossip_kernels.gossip_mix_dp_rowwise,
         (mix, w, z, act)),
        ("gossip_mix_sparse_dp", gossip_kernels.gossip_mix_sparse_dp,
         gossip_kernels.gossip_mix_sparse_dp_rowwise, (idx, wgt, w, z, act)),
    ]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("n,d", [(1, 1), (12, 513), (37, 66689), (226, 4099)])
@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
def test_staged_gossip_kernels_equal_the_rowwise_kernel_bitwise(cuda, n, d, ratio):
    """gossip_mix, gossip_mix_dp and gossip_mix_sparse_dp through their
    planned kernel (staged at every case but the dense N=226, whose M^T
    overflows shared memory) give the bits of the row-wise kernel (the
    same FMAs in the same order), whose launches are counted apart."""
    w, z, act, mix, idx, wgt = _gossip_case(n, d, ratio, seed=n + d, device=cuda)
    for name, kernel, rowwise, args in _rowwise_pairs(w, z, act, mix, idx, wgt):
        before = dict(gossip_kernels.LAUNCHES), dict(gossip_kernels.ROWWISE_LAUNCHES)
        got, want = kernel(*args), rowwise(*args)
        torch.cuda.synchronize()
        assert gossip_kernels.LAUNCHES[name] == before[0][name] + 1
        assert gossip_kernels.ROWWISE_LAUNCHES[name] == before[1][name] + 1
        assert torch.equal(_bits(got), _bits(want)), name


# the largest N each staged kernel takes (gossip_mix_sparse_dp with the
# trainer's 8-slot table), from the pure plan
_STAGED_LIMIT = {
    name: max(n for n in range(1, 1200) if gossip_kernels._plan(name, n, s, 300).design == "staged")
    for name, s in (("gossip_mix", 0), ("gossip_mix_dp", 0), ("gossip_mix_sparse_dp", 8))}


@pytest.mark.parametrize("name", ["gossip_mix", "gossip_mix_dp", "gossip_mix_sparse_dp"])
@pytest.mark.parametrize("side", [0, 1])
def test_gossip_kernels_on_each_side_of_the_staged_limit(cuda, name, side):
    """At the largest N the staged kernel takes, and one more (the
    row-wise kernel): within GOSSIP_ATOL of the twin, bitwise the
    row-wise kernel, inactive rows copied."""
    n = _STAGED_LIMIT[name] + side
    w, z, act, mix, idx, wgt = _gossip_case(n, 300, 0.3, seed=n, device=cuda)
    _, kernel, rowwise, args = next(p for p in _rowwise_pairs(w, z, act, mix, idx, wgt)
                                    if p[0] == name)
    plain = {"gossip_mix": ref.gossip_mix_plain, "gossip_mix_dp": ref.gossip_mix_dp_plain,
             "gossip_mix_sparse_dp": ref.gossip_mix_sparse_dp_plain}[name]
    s = idx.shape[1] if "sparse" in name else 0
    assert gossip_kernels._plan(name, n, s, 300).design == ("rowwise" if side else "staged")
    got = kernel(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=GOSSIP_ATOL)
    assert torch.equal(_bits(got), _bits(rowwise(*args)))
    inactive = act == 0
    assert torch.equal(got[inactive], w[inactive])


def test_gossip_kernels_keep_inactive_rows_bitwise_under_nan(cuda):
    w, z, act, mix, idx, wgt = _gossip_case(12, 513, 0.0, seed=3, device=cuda)
    act[4] = 0.0
    mix = mixing_matrix(torch.ones((12, 12), device=cuda) - torch.eye(12, device=cuda), act, 7)
    idx, wgt = neighbor_table(torch.ones((12, 12), device=cuda) - torch.eye(12, device=cuda), act, 7)
    w[0, 7] = float("nan")
    for name, kernel, _, args in _gossip_calls(w, z, act, mix, idx, wgt):
        out = kernel(*args)
        assert torch.equal(out[4], w[4]), name
        assert torch.isnan(out[1, 7]), name


def test_gossip_wrapper_checks(cuda):
    w, z, act, mix, idx, wgt = _gossip_case(6, 40, 0.3, seed=5, device=cuda)
    before = dict(gossip_kernels.LAUNCHES)
    with pytest.raises(TypeError, match="int32"):
        gossip_kernels.gossip_mix_sparse(idx.long(), wgt, w, act)
    with pytest.raises(ValueError, match="mix must be"):
        gossip_kernels.gossip_mix(mix[:, :5].contiguous(), w, act)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_kernels.gossip_mix_dp(mix, w, z.t().contiguous().t(), act)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_kernels.gossip_mix(mix, w, act.cpu())
    with pytest.raises(RuntimeError, match="require"):
        gossip_kernels.gossip_mix(mix, w.clone().requires_grad_(True), act)
    assert gossip_kernels.LAUNCHES == before


@pytest.mark.parametrize("n,repr_", [(12, "dense"), (40, "sparse")])
@pytest.mark.parametrize("sigma", [0.0, 0.01])
def test_training_rounds_go_through_the_gossip_kernels(cuda, n, repr_, sigma):
    from repro_torch.models import LSTMModel

    gen = torch.Generator(device=cuda).manual_seed(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 64, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    counts = np.full(n, 64, np.int32)
    trainer = GluADFL(LSTMModel(hidden=32).as_model(), adam(1e-3),
                      FLConfig(num_nodes=n, inactive_ratio=0.3), mixer="kernel",
                      gossip_repr=repr_, dp_noise_sigma=sigma)
    name = {("dense", False): "gossip_mix", ("sparse", False): "gossip_mix_sparse",
            ("dense", True): "gossip_mix_dp", ("sparse", True): "gossip_mix_sparse_dp"}[
                (repr_, sigma > 0)]
    before = gossip_kernels.LAUNCHES[name]
    _, hist, state = trainer.train(gen, x, y, counts, batch_size=16, rounds=5)
    assert gossip_kernels.LAUNCHES[name] == before + 5
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert bool(torch.isfinite(state.params).all())


@pytest.mark.parametrize("n,repr_", [(12, "dense"), (40, "sparse")])
@pytest.mark.parametrize("sigma", [0.0, 0.01])
def test_masked_rounds_are_bitwise_unmasked_through_the_gossip_kernels(cuda, n, repr_, sigma):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 64, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    counts = np.full(n, 64, np.int32)
    runs = {}
    for impl in ("allgather", "masked"):
        trainer = GluADFL(LSTMModel(hidden=32).as_model(), adam(1e-3),
                          FLConfig(num_nodes=n, inactive_ratio=0.3), mixer="kernel",
                          gossip_impl=impl, gossip_repr=repr_, dp_noise_sigma=sigma)
        before = dict(gossip_kernels.LAUNCHES)
        _, hist, state = trainer.train(torch.Generator(device=cuda).manual_seed(2), x, y, counts,
                                       batch_size=16, rounds=4)
        ran = {k: v - before[k] for k, v in gossip_kernels.LAUNCHES.items() if v != before[k]}
        assert list(ran.values()) == [4], ran
        runs[impl] = (hist, state)
    (ha, a), (hb, b) = runs["allgather"], runs["masked"]
    assert ha == hb and torch.equal(a.params, b.params)
    assert all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state)


def test_sweep_group_eval_is_one_launch_bitwise_per_scenario_applies(cuda):
    """G populations over shared windows: one launch with G groups, each
    group's row bitwise its own G=1 launch and within ATOL of the twin."""
    lstm = LSTMModel(hidden=128)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rows = [lstm.init(gen) for _ in range(5)]
    stacked = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    x = torch.randn((37, L), generator=gen, device=cuda)
    before = lstm_cell.LAUNCHES
    with torch.no_grad():
        got = lstm.apply_groups(stacked, x)
    assert lstm_cell.LAUNCHES == before + 1 and got.shape == (5, 37)
    for g, params in enumerate(rows):
        with torch.no_grad():
            assert torch.equal(got[g], lstm.apply(params, x)), g
    want = lstm_forward_plain(x[None, :, :, None].expand(5, -1, -1, -1).contiguous(),
                              *(stacked[k] for k in ("wx", "wh", "b", "w_out", "b_out")))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("repr_", ["dense", "sparse"])
def test_sweep_on_the_card_matches_the_cpu(cuda, repr_):
    """A small sweep from the same initial params and the same
    (CPU-drawn) draws on the card and on the CPU: losses, val records
    and params within ATOL; no gossip kernel runs (the sweep mixes
    with the tree mixer) and each eval is one ``lstm_forward`` launch."""
    from repro_torch.core import SweepGrid
    from repro_torch.utils.rng import draw_sweep

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rounds = 8, 4
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 32, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    counts = np.full(n, 32, np.int32)
    val = (x[0, :20], y[0, :20])
    grid = SweepGrid.build(("ring", "random"), (0.0, 0.4), (0, 1), num_nodes=n,
                           dp_sigmas=(0.01,))
    runs = {}
    for device in ("cpu", cuda):
        trainer = GluADFL(LSTMModel(hidden=16).as_model(), adam(1e-3),
                          FLConfig(num_nodes=n, comm_batch=3), gossip_repr=repr_, device=device)
        gens = [torch.Generator().manual_seed(s) for s in grid.seeds]
        flat = torch.cat([trainer._draw_params(gen).cpu() for gen in gens])
        init = trainer.state_from_params({k: v.reshape(grid.size, n, *v.shape[1:])
                                          for k, v in trainer.layout.views(flat).items()})
        draws = [draw_sweep(gens, torch.as_tensor(counts), local_steps=1, batch_size=8,
                            resample=grid.resample.tolist(), dp_dim=trainer.layout.dim)
                 for _ in range(rounds)]
        moved = [type(d)(*(None if t is None else t.to(device) for t in
                           (d.u_act, d.scores, d.batch_idx, d.dp_noise))) for d in draws]
        before = (lstm_cell.LAUNCHES, dict(gossip_kernels.LAUNCHES))
        runs[str(device)] = trainer.train_sweep(x, y, counts, grid=grid, rounds=rounds, chunk=3,
                                                eval_every=2, val_data=val, states=init,
                                                draws=moved)
        if device == cuda:
            assert lstm_cell.LAUNCHES == before[0] + rounds // 2
            assert gossip_kernels.LAUNCHES == before[1]
    (_, hc, sc), (_, hg, sg) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(hc, hg):
        np.testing.assert_allclose([r["loss"] for r in a], [r["loss"] for r in b], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose([r["val_rmse"] for r in a if "val_rmse" in r],
                                   [r["val_rmse"] for r in b if "val_rmse" in r], rtol=0,
                                   atol=ATOL)
    torch.testing.assert_close(sg.params.cpu(), sc.params, rtol=0, atol=ATOL)
    assert torch.equal(sg.staleness.cpu(), sc.staleness)


@pytest.mark.parametrize("form", ["three_args", "one_arg"])
def test_train_eval_fn_on_the_card_matches_the_cpu(cuda, form):
    """``GluADFL.train`` with a streaming ``eval_fn`` from the same
    initial params and (CPU-drawn) draws on the card and on the CPU:
    losses and eval records within ATOL; the 3-argument form's forward
    is one ``lstm_forward`` launch an eval round."""
    from repro_torch.utils.rng import draw_round

    torch.backends.cuda.matmul.allow_tf32 = False
    n, rounds = 8, 6
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 32, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    counts = np.full(n, 32, np.int32)
    val = (x[0, :20], y[0, :20] * 50.0 + 100.0)
    model = LSTMModel(hidden=16).as_model()

    def mgdl(p, vx, vy):
        with torch.no_grad():
            pred = model.apply(p, vx) * 50.0 + 100.0
            return {"val_rmse": torch.sqrt(torch.mean(torch.square(pred - vy)))}

    def norm(p):
        return {"wh_norm": torch.linalg.vector_norm(p["wh"])}

    eval_fn = mgdl if form == "three_args" else norm
    gen = torch.Generator().manual_seed(2)
    draws = [draw_round(gen, torch.as_tensor(counts), local_steps=1, batch_size=8,
                        random_topology=True) for _ in range(rounds)]
    init = None
    runs = {}
    for device in ("cpu", cuda):
        trainer = GluADFL(model, adam(1e-3), FLConfig(num_nodes=n, comm_batch=3), device=device)
        if init is None:
            init = trainer.layout.views(trainer.init(torch.Generator().manual_seed(0)).params)
        moved = [type(d)(*(None if t is None else t.to(device) for t in
                           (d.u_act, d.scores, d.batch_idx, d.dp_noise))) for d in draws]
        before = lstm_cell.LAUNCHES
        runs[str(device)] = trainer.train(
            None, x, y, counts, batch_size=8, rounds=rounds, eval_every=2, eval_fn=eval_fn,
            val_data=val if form == "three_args" else None, chunk=4,
            state=trainer.state_from_params(init), draws=moved)[1]
        if device == cuda:
            assert lstm_cell.LAUNCHES == before + (rounds // 2 if form == "three_args" else 0)
    key = "val_rmse" if form == "three_args" else "wh_norm"
    hc, hg = runs["cpu"], runs[str(cuda)]
    assert [sorted(h) for h in hc] == [sorted(h) for h in hg]
    np.testing.assert_allclose([h["loss"] for h in hg], [h["loss"] for h in hc], rtol=0,
                               atol=ATOL)
    got, want = ([h[key] for h in hist if key in h] for hist in (hg, hc))
    assert len(got) == rounds // 2
    np.testing.assert_allclose(got, want, rtol=1e-5 if key == "val_rmse" else 0,
                               atol=ATOL)


def test_fig4_evals_through_lstm_forward_three_launches_an_eval_round(cuda):
    """Fig 4 on the card: its sweep path calls the mg/dL ``eval_fn`` once
    a scenario, so 3 ``lstm_forward`` launches an eval round, and no
    gossip kernel; its serial path the same launches and curves."""
    from repro_torch.paper import fig4_topology
    from repro_torch.paper.common import Scale

    torch.backends.cuda.matmul.allow_tf32 = False
    scale = Scale(rounds=4, max_patients=6, hidden=16, batch_size=8, device="cuda")
    curves = {}
    for serial in (False, True):
        before = (lstm_cell.LAUNCHES, dict(gossip_kernels.LAUNCHES))
        curves[serial] = fig4_topology.run(scale, datasets=["ohiot1dm"], eval_every=2,
                                           serial=serial)["ohiot1dm"]
        assert lstm_cell.LAUNCHES == before[0] + 3 * 2
        assert gossip_kernels.LAUNCHES == before[1]
    for topo, curve in curves[False].items():
        assert [r for r, _ in curve] == [1, 3]
        np.testing.assert_allclose([v for _, v in curve], [v for _, v in curves[True][topo]],
                                   rtol=1e-4, atol=0)


def test_personalized_cohort_is_served_with_a_bitwise_selfcheck(cuda):
    from repro_torch.core import personalize, personalize_loop
    from repro_torch.utils.rng import draw_personalize

    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16), personalize_steps=10)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 24, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    counts = np.array([24, 12, 3, 1])
    params = sv.personalize(["a", "b", "c", "d"], x, y, counts,
                            generator=torch.Generator(device=cuda).manual_seed(3))
    assert sv.num_rows == 5 and params["wh"].shape == (4, 128, 512)
    assert bool(torch.isfinite(sv.personalize_losses).all())
    windows = rng.normal(size=(37, L)).astype(np.float32)
    reqs = [Request(rid=i, patient=i % 5, window=w) for i, w in enumerate(windows)]
    before = lstm_cell.LAUNCHES
    preds = replay(sv, MicroBatcher(sv.buckets), reqs)
    assert lstm_cell.LAUNCHES > before
    assert selfcheck(sv, reqs, preds) == 0
    idx = draw_personalize(torch.Generator(device=cuda).manual_seed(4), [12], 24, 10, 32)[0]
    one = personalize(sv.model, sv.optimizer, sv.population, idx, x[1], y[1])
    loop = personalize_loop(sv.model, sv.optimizer, sv.population, idx, x[1], y[1])
    assert all(torch.equal(one[k], loop[k]) for k in one)


def _swa_inputs(b, s, h, kh, hd, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=shape), dtype=dtype, device=device)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 128, 2, 2, 64, 64), (1, 256, 12, 1, 128, 100), (2, 1024, 4, 2, 64, 300),
    (1, 960, 3, 1, 128, 1024), (1, 320, 2, 1, 64, 4096), (1, 192, 2, 2, 128, 1),
    # S % 128 == 64 at B=2: the last q tile's rows past S, across batches
    (2, 192, 4, 2, 128, 100), (2, 320, 12, 1, 64, 4096),
    # Mistral-Large's 12 query heads a KV head
    (2, 2048, 24, 2, 128, 1024),
    # hd 256 on the scalar kernel (RecurrentGemma's one KV head, window
    # 2048), S % 128 == 64 at B=2; hd 96 zero-padded to 128
    (1, 1024, 2, 1, 256, 2048), (2, 192, 4, 2, 256, 100), (1, 320, 3, 1, 96, 100),
    (2, 1024, 4, 2, 96, 300),
    # hd 512 in two chunks of 256 columns, hd 288 zero-padded to 512
    (1, 1024, 2, 1, 512, 2048), (2, 192, 4, 2, 512, 100), (1, 320, 3, 1, 288, 100),
    (2, 1024, 4, 2, 288, 300)])
def test_swa_kernel_matches_plain(cuda, dtype, b, s, h, kh, hd, window):
    q, k, v = _swa_inputs(b, s, h, kh, hd, dtype, seed=s + window, device=cuda)
    before = swa_kernel.LAUNCHES
    got = swa_kernel.swa_attention(q, k, v, window=window)
    again = swa_kernel.swa_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert swa_kernel.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = ref.swa_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=SWA_ATOL[dtype])
    if dtype == torch.bfloat16:  # and elementwise within the rounding of P and of o
        o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=window)
        err = (got.float() - o32).abs()
        bound = ref.swa_bf16_bound(q, k, v, window=window)
        assert bool((err <= bound).all()), float((err / bound).max())


def test_swa_wrapper_checks(cuda):
    q, k, v = _swa_inputs(1, 128, 4, 2, 64, torch.float32, seed=0, device=cuda)
    before = swa_kernel.LAUNCHES
    with pytest.raises(RuntimeError, match="require"):
        swa_kernel.swa_attention(q.clone().requires_grad_(True), k, v, window=64)
    with pytest.raises(TypeError, match="bfloat16"):
        swa_kernel.swa_attention(q, k.bfloat16(), v, window=64)
    with pytest.raises(ValueError, match="H % K"):
        swa_kernel.swa_attention(q[:, :, :3].contiguous(), k, v, window=64)
    with pytest.raises(ValueError, match="contiguous"):
        swa_kernel.swa_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, window=64)
    with pytest.raises(ValueError, match="window"):
        swa_kernel.swa_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple of 64"):
        swa_kernel.swa_attention(q[:, :100].contiguous(), k[:, :100].contiguous(),
                                 v[:, :100].contiguous(), window=64)
    with pytest.raises(ValueError, match="CUDA"):
        swa_kernel.swa_attention(q, k.cpu(), v, window=64)
    offset = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)  # 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        swa_kernel.swa_attention(offset.copy_(q), k, v, window=64)
    assert swa_kernel.LAUNCHES == before
    with torch.no_grad():
        swa_kernel.swa_attention(q.clone().requires_grad_(True), k, v, window=64)
    assert swa_kernel.LAUNCHES == before + 1
    # hd > 256 is taken, on the kernel (hd 288 zero-padded to 512), not refused
    wide = _swa_inputs(1, 128, 4, 2, 288, torch.float32, seed=1, device=cuda)
    got = swa_kernel.swa_attention(*wide, window=64)
    assert swa_kernel.LAUNCHES == before + 2 and got.shape == wide[0].shape
    torch.testing.assert_close(got, ref.swa_attention_plain(*wide, window=64), rtol=0,
                               atol=SWA_ATOL[torch.float32])


def test_gqa_attention_banded_branch_runs_the_kernel(cuda):
    from repro_torch.nn import attention

    q, k, v = _swa_inputs(1, 3072, 4, 2, 64, torch.float32, seed=3, device=cuda)
    before, branches = swa_kernel.LAUNCHES, dict(attention.BRANCHES)
    got = attention.gqa_attention(q, k, v, causal=True, window=1024)
    assert swa_kernel.LAUNCHES == before + 1
    assert attention.BRANCHES["banded"] == branches["banded"] + 1
    want = attention.banded_flash_attention(q, k, v, window=1024)
    torch.testing.assert_close(got, want, rtol=0, atol=SWA_ATOL[torch.float32])


def test_lm_prefill_and_decode_through_the_kernel(cuda):
    import dataclasses

    from repro_torch.arch import build_arch
    from repro_torch.config import get_arch_config

    cfg = dataclasses.replace(get_arch_config("mistral-large-123b").reduced(),
                              sliding_window=1024)
    arch = build_arch(cfg)
    params = arch.init_params(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 3072),
                           generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    before = swa_kernel.LAUNCHES
    logits, caches = arch.prefill_fn(params, {"tokens": tokens})
    assert swa_kernel.LAUNCHES == before + cfg.num_layers
    cpu_params = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    want, want_caches = arch.prefill_fn(cpu_params, {"tokens": tokens.cpu()})
    torch.testing.assert_close(logits.cpu(), want, rtol=0, atol=1e-4)
    torch.testing.assert_close(caches.k.cpu(), want_caches.k, rtol=0, atol=1e-5)
    step, _ = arch.decode_fn(params, caches, {"token": tokens[:, :1], "pos": 3072})
    want_step, _ = arch.decode_fn(cpu_params, want_caches, {"token": tokens[:, :1].cpu(), "pos": 3072})
    torch.testing.assert_close(step.cpu(), want_step, rtol=0, atol=1e-4)


# ------------------------------------------------------------ baselines

def _baseline_data(n=6, m=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, L)).astype(np.float32)
    y = (x @ rng.normal(size=L).astype(np.float32) * 0.3).astype(np.float32)
    return x, y, rng.integers(m // 2, m + 1, size=n).astype(np.int32)


def _assert_trained_alike(card, cpu, opt):
    """Card against CPU from the same draws: autograd's matmuls sum in
    another order on each (TF32 off), so as ``tests/test_torch_train.py``
    holds the port to JAX: SGD within 1e-5; Adam's losses within 1e-4
    and params within a relative norm of 1e-3."""
    (pa, ha), (pb, hb) = card, cpu
    la, lb = np.array([h["loss"] for h in ha]), np.array([h["loss"] for h in hb])
    va = np.concatenate([pa[k].cpu().numpy().ravel() for k in sorted(pa)])
    vb = np.concatenate([pb[k].numpy().ravel() for k in sorted(pb)])
    assert np.isfinite(la).all() and len(la) == len(lb)
    if opt == "sgd":
        np.testing.assert_allclose(la, lb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(la, lb, rtol=0, atol=1e-4)
        assert np.linalg.norm(va - vb) <= 1e-3 * np.linalg.norm(vb)


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-2), ("adam", 2e-3)])
def test_fedavg_on_the_card_matches_the_cpu(cuda, opt, lr):
    from repro_torch.utils.rng import draw_round

    x, y, counts = _baseline_data()
    init = LSTMModel(hidden=16).init(torch.Generator().manual_seed(0))
    draws = [draw_round(torch.Generator().manual_seed(r), torch.as_tensor(counts),
                        local_steps=2, batch_size=8, random_topology=False) for r in range(3)]
    runs = []
    for dev in (cuda, "cpu"):
        fa = FedAvg(LSTMModel(hidden=16).as_model(), get_optimizer(opt, lr),
                    FLConfig(num_nodes=6, inactive_ratio=0.3, local_steps=2), device=dev)
        runs.append(fa.train(None, x, y, counts, batch_size=8, rounds=3, params=init,
                             draws=draws))
    _assert_trained_alike(*runs, opt)


@pytest.mark.parametrize("cls", [MAML, MetaSGD], ids=["maml", "metasgd"])
def test_meta_step_on_the_card_matches_the_cpu(cuda, cls):
    from repro_torch.utils.rng import draw_meta

    x, y, counts = _baseline_data()
    init = LSTMModel(hidden=16).init(torch.Generator().manual_seed(1))
    draws = [draw_meta(torch.Generator().manual_seed(s), torch.as_tensor(counts),
                       inner_steps=3, batch_size=8) for s in range(2)]
    runs = []
    for dev in (cuda, "cpu"):
        meta = cls(LSTMModel(hidden=16).as_model(), get_optimizer("sgd", 0.5), inner_lr=5e-2,
                   inner_steps=3, device=dev)
        params, _, hist = meta.train(None, x, y, counts, batch_size=8, steps=2, params=init,
                                     draws=draws)
        runs.append((params, hist))
    _assert_trained_alike(*runs, "sgd")


def test_baseline_eval_goes_through_the_kernel(cuda):
    """The Table-4 evaluation of an LSTM baseline: one ``lstm_forward``
    launch per patient (``paper.common.eval_population``) and a pooled
    supervised val eval at REPLACE-BG's R=71,317 windows in one launch,
    within 1e-5 of the plain twin."""
    from repro_torch.data import load_federated_dataset
    from repro_torch.paper.common import Scale, eval_population, load, pooled

    fed = load_federated_dataset("replace-bg", fast=True)
    vx, vy = pooled(fed, "val")
    assert vx.shape == (71_317, L)
    model = LSTMModel(hidden=128)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    x = torch.as_tensor(vx, device=cuda)
    before = lstm_cell.LAUNCHES
    got = model.apply(params, x)
    torch.cuda.synchronize()
    assert lstm_cell.LAUNCHES == before + 1
    want = lstm_forward_plain(x[None, :, :, None], *(params[k][None] for k in
                                                     ("wx", "wh", "b", "w_out", "b_out")))[0]
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    ohio = load("ohiot1dm", Scale(max_patients=None))
    small = LSTMModel(hidden=16)
    sp = small.init(torch.Generator(device=cuda).manual_seed(0))
    before = lstm_cell.LAUNCHES
    on_card = eval_population(small.as_model(), sp, ohio)
    assert lstm_cell.LAUNCHES == before + ohio.num_nodes
    on_cpu = eval_population(small.as_model(), {k: v.cpu() for k, v in sp.items()}, ohio)
    # forecasts within 1e-5 (normalized) move the mg/dL metrics by < 1e-4 of themselves
    for k in on_card:
        assert on_card[k] == pytest.approx(on_cpu[k], rel=1e-4), (k, on_card[k], on_cpu[k])
    # the supervised trainer's val eval on the card, through the kernel
    before = lstm_cell.LAUNCHES
    _, hist = train_supervised(small.as_model(), adam(2e-3), torch.Generator(device=cuda),
                               vx[:4096], vy[:4096], steps=4, batch_size=64,
                               val=(vx[:2048], vy[:2048]), eval_every=2, device=cuda)
    assert lstm_cell.LAUNCHES == before + 2 and "val_loss" in hist[-1]


def test_baseline_trainers_need_a_device_unless_the_cpu_is_asked_for(cuda, monkeypatch):
    x, y, counts = _baseline_data()
    model = LSTMModel(hidden=8).as_model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: FedAvg(model, adam(1e-3), FLConfig(num_nodes=6), **kw),
                 lambda **kw: MAML(model, adam(1e-3), **kw),
                 lambda **kw: train_supervised(model, adam(1e-3), torch.Generator(), x[0], y[0],
                                               steps=1, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
