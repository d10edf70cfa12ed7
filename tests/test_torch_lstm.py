"""The port's LSTM against the JAX reference: the one-step cell, the
model's ``apply`` (shared weights) and ``apply_rows`` (one weight set
per row), the CPU dispatch, the kernel wrapper's refusals and the CUDA
build driver.  Inputs come from numpy with a seed; JAX parameters cross
through ``params_from_numpy``.

Tolerance: ``atol=1e-5`` on normalized forecasts.  Both sides compute in
fp32 and differ only in summation order, which drifts by ~1e-7 over 12
recurrent steps at H=128.

The trainer's hand-written backpropagation through time
(``LSTMModel.forward_for_grad``, here on the gate kernels' plain
twins) is held against ``torch.autograd.grad`` through ``apply_nodes``:
losses within 1e-6 relative, each leaf's gradient within ``VG_RTOL`` of
the leaf's largest |gradient| (fp32 sums over up to L·B = 84 terms in
another order: dwh as one product over the steps, db and, at I = 1, dwx
summed a step at a time, at I > 1 dwx as one product over the steps).

The CUDA kernels themselves are held against their plain twins in
``tests/test_torch_gpu.py``.
"""
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell import lstm_cell_pallas
from repro.kernels.ref import lstm_cell_ref
from repro.models import LSTMModel as JaxLSTM
from repro_torch.core import gluadfl
from repro_torch.kernels import _build, lstm_cell, ops
from repro_torch.kernels.ref import lstm_cell_plain, lstm_forward_plain
from repro_torch.models import LSTMModel, NBeatsModel, params_from_numpy
from repro_torch.models import lstm as models_lstm
from repro_torch.utils.pytree import ParamLayout

ATOL = 1e-5
L = 12
VG_RTOL = 1e-5


def _np_params(hidden, seed, input_size=1):
    p = JaxLSTM(hidden=hidden, input_size=input_size).init(jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _cell_inputs(b, i, h, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, i)).astype(np.float32),
        rng.normal(size=(b, h)).astype(np.float32),
        rng.normal(size=(b, h)).astype(np.float32),
        (rng.normal(size=(i, 4 * h)) / np.sqrt(i)).astype(np.float32),
        (rng.normal(size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32),
        rng.normal(size=(4 * h,)).astype(np.float32),
    )


# ------------------------------------------------------------------- (a)


@pytest.mark.parametrize("b,i,h", [(4, 1, 8), (16, 3, 32), (128, 1, 128)])
def test_cell_plain_matches_jax_ref(b, i, h):
    args = _cell_inputs(b, i, h, seed=b + h)
    hj, cj = lstm_cell_ref(*(jnp.asarray(a) for a in args))
    ht, ct = lstm_cell_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


def test_cell_plain_matches_pallas_interpret():
    args = _cell_inputs(128, 1, 128, seed=7)
    hj, cj = lstm_cell_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    ht, ct = lstm_cell_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


# ------------------------------------------------------------------- (b)


@pytest.mark.parametrize("hidden", [8, 32, 128])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_matches_jax_apply(hidden, use_kernel):
    """Shared weights, a batch of windows: the port's apply against
    LSTMModel.apply (use_kernel=True is the Pallas interpret path at
    H=128; below it ops.lstm_cell falls back to the reference)."""
    np_params = _np_params(hidden, seed=hidden)
    x = np.random.default_rng(hidden).normal(size=(9, L)).astype(np.float32)
    want = JaxLSTM(hidden=hidden, use_kernel=use_kernel).apply(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    got = LSTMModel(hidden=hidden).apply(params_from_numpy(np_params, "cpu"), _t(x))
    assert got.shape == (9,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ------------------------------------------------------------------- (c)


@pytest.mark.parametrize("hidden", [8, 128])
def test_apply_rows_matches_per_row_jax_apply(hidden):
    g = 5
    rows = [_np_params(hidden, seed=s) for s in range(g)]
    x = np.random.default_rng(1).normal(size=(g, L)).astype(np.float32)
    stacked = params_from_numpy({k: np.stack([r[k] for r in rows]) for k in rows[0]}, "cpu")
    got = LSTMModel(hidden=hidden).apply_rows(stacked, _t(x))
    jm = JaxLSTM(hidden=hidden)
    want = [float(jm.apply({k: jnp.asarray(v) for k, v in rows[i].items()},
                           jnp.asarray(x[i : i + 1]))[0]) for i in range(g)]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_apply_rows_row_is_bitwise_independent_of_batch():
    """The serving contract on the CPU path: row g of a G-row call is
    bitwise the same row called alone, and the shared-weight apply."""
    g, hidden = 6, 32
    rows = [_np_params(hidden, seed=10 + s) for s in range(g)]
    stacked = params_from_numpy({k: np.stack([r[k] for r in rows]) for k in rows[0]}, "cpu")
    x = _t(np.random.default_rng(2).normal(size=(g, L)))
    model = LSTMModel(hidden=hidden)
    full = model.apply_rows(stacked, x)
    for i in range(g):
        one = {k: v[i : i + 1] for k, v in stacked.items()}
        assert torch.equal(model.apply_rows(one, x[i : i + 1])[0], full[i])
        shared = {k: v[i] for k, v in stacked.items()}
        assert torch.equal(model.apply(shared, x[i : i + 1])[0], full[i])


def test_init_matches_jax_shapes_and_forget_bias():
    like = _np_params(16, seed=0, input_size=2)
    got = LSTMModel(hidden=16, input_size=2).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in like.items()}
    assert (got["b"][16:32] == 1).all() and (got["b"][:16] == 0).all() and (got["b"][32:] == 0).all()
    again = LSTMModel(hidden=16, input_size=2).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


# ------------------------------------------------------- plain + dispatch


def _forward_inputs(g, r, steps, isz, hsz, seed):
    rng = np.random.default_rng(seed)
    return tuple(_t(a) for a in (
        rng.normal(size=(g, r, steps, isz)),
        rng.normal(size=(g, isz, 4 * hsz)) / np.sqrt(isz),
        rng.normal(size=(g, hsz, 4 * hsz)) / np.sqrt(hsz),
        rng.normal(size=(g, 4 * hsz)),
        rng.normal(size=(g, hsz, 1)) / np.sqrt(hsz),
        rng.normal(size=(g, 1)),
    ))


def test_forward_plain_multirow_multivariate_matches_jax():
    """R > 1 rows per group and I > 1 inputs: each group is the JAX cell
    scanned over L steps, then the head."""
    g, r, steps, isz, hsz = 3, 4, 5, 2, 16
    args = _forward_inputs(g, r, steps, isz, hsz, seed=3)
    got = lstm_forward_plain(*args)
    x, wx, wh, b, w_out, b_out = (jnp.asarray(a.numpy()) for a in args)
    for gi in range(g):
        h = c = jnp.zeros((r, hsz))
        for t in range(steps):
            h, c = lstm_cell_ref(x[gi, :, t], h, c, wx[gi], wh[gi], b[gi])
        want = (h @ w_out[gi] + b_out[gi])[:, 0]
        np.testing.assert_allclose(got[gi].numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_cpu_dispatch_runs_plain_without_launching():
    args = _forward_inputs(2, 1, L, 1, 8, seed=4)
    before = lstm_cell.LAUNCHES
    assert torch.equal(ops.lstm_forward(*args), lstm_forward_plain(*args))
    assert lstm_cell.LAUNCHES == before


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    """The kernel has no backward: with grad mode on, an input that
    requires grad is refused before anything else is checked (a ctypes
    launch would return a tensor without grad_fn and training would
    silently stop learning).  Under no_grad the same call gets past that
    check (and then stops at the CPU-tensor check)."""
    args = list(_forward_inputs(2, 1, L, 1, 8, seed=6))
    args[2].requires_grad_(True)
    before = lstm_cell.LAUNCHES
    with pytest.raises(RuntimeError, match="wh require"):
        lstm_cell.lstm_forward(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        lstm_cell.lstm_forward(*args)
    assert lstm_cell.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors_and_ops_refuses_other_devices():
    args = _forward_inputs(2, 1, L, 1, 8, seed=5)
    before = lstm_cell.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cell.lstm_forward(*args)
    with pytest.raises(ValueError, match="meta"):
        ops.lstm_forward(*(a.to("meta") for a in args))
    assert lstm_cell.LAUNCHES == before


# ------------------------------------------- the hand-written gradient


def _vg_case(model, n=3, seed=0):
    """Distinct per-row params, a batch and targets from a seed."""
    layout = ParamLayout.of(model.init(torch.Generator().manual_seed(seed)))
    rows = [model.init(torch.Generator().manual_seed(seed + r)) for r in range(n)]
    flat = layout.flatten({k: torch.stack([r[k] for r in rows]) for k in layout.names})
    rng = np.random.default_rng(seed)
    isz = getattr(model, "input_size", 1)
    shape = (n, 7, model.history_len) + ((isz,) if isz > 1 else ())
    return layout, flat, _t(rng.normal(size=shape)), _t(rng.normal(size=(n, 7)))


def _autograd(model, layout, flat, bx, by):
    p = flat.clone().requires_grad_(True)
    losses = torch.mean(torch.square(model.apply_nodes(layout.views(p), bx) - by), dim=1)
    (grads,) = torch.autograd.grad(losses.sum(), p)
    return losses.detach(), grads


@pytest.mark.parametrize("hsz", [8, 12, 128])
@pytest.mark.parametrize("isz", [1, 2])
@pytest.mark.parametrize("steps", [1, L])
@pytest.mark.parametrize("bsz", [1, 7])
def test_value_and_grad_nodes_matches_autograd(hsz, isz, steps, bsz):
    model = LSTMModel(history_len=steps, hidden=hsz, input_size=isz)
    layout, flat, bx, by = _vg_case(model, seed=hsz + isz + steps)
    bx, by = bx[:, :bsz], by[:, :bsz]
    losses, backward = model.forward_for_grad(layout, flat, bx, by)
    grads = backward()
    want_l, want_g = _autograd(model, layout, flat, bx, by)
    assert grads.shape == flat.shape and not grads.requires_grad
    torch.testing.assert_close(losses, want_l, rtol=1e-6, atol=0)
    got, want = layout.views(grads), layout.views(want_g)
    for k in layout.names:
        scale = float(want[k].abs().max())
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=VG_RTOL * scale, msg=k)


def test_mse_value_and_grad_routes_the_lstm_by_hand_and_nbeats_through_autograd(monkeypatch):
    """The LSTM's loss and gradient come from its hand-written
    backpropagation (one forward and one backward gate call a step, no
    autograd); N-BEATS, which has none, from autograd through
    ``apply_nodes``.  Either way the step's ``step.forward`` and
    ``step.backward`` spans open once each, in that order."""
    calls = {"fwd": 0, "bwd": 0, "autograd": 0}
    spans = []
    real_span = gluadfl.span

    def recording(name):
        spans.append(name)
        return real_span(name)

    fwd, bwd, grad = models_lstm.lstm_gates_fwd, models_lstm.lstm_gates_bwd, torch.autograd.grad

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(models_lstm, "lstm_gates_fwd", count("fwd", fwd))
    monkeypatch.setattr(models_lstm, "lstm_gates_bwd", count("bwd", bwd))
    monkeypatch.setattr(torch.autograd, "grad", count("autograd", grad))
    monkeypatch.setattr(gluadfl, "span", recording)
    lstm = LSTMModel(hidden=8)
    layout, flat, bx, by = _vg_case(lstm)
    assert lstm.as_model().forward_for_grad is not None
    gluadfl.mse_value_and_grad(lstm.as_model(), layout, flat, bx, by)
    assert calls == {"fwd": L, "bwd": L, "autograd": 0}
    assert spans == ["step.forward", "step.backward"]

    nbeats = NBeatsModel(history_len=L, hidden=16)
    layout, flat, bx, by = _vg_case(nbeats)
    assert nbeats.as_model().forward_for_grad is None
    losses, grads = gluadfl.mse_value_and_grad(nbeats.as_model(), layout, flat, bx, by)
    assert calls == {"fwd": L, "bwd": L, "autograd": 1}
    assert spans == ["step.forward", "step.backward"] * 2
    want_l, want_g = _autograd(nbeats, layout, flat, bx, by)
    assert torch.equal(losses, want_l) and torch.equal(grads, want_g)


# ---------------------------------------------------------------- build


def _fake_nvcc(tmp_path, fail=False):
    """An ``nvcc`` stand-in that writes its ``-o`` target (or fails)."""
    script = tmp_path / "fake_nvcc"
    body = "import sys\n"
    body += "sys.exit(3)\n" if fail else (
        "out = sys.argv[sys.argv.index('-o') + 1]\nopen(out, 'w').write('lib')\n")
    script.write_text(f"#!{sys.executable}\n{body}")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_compiles_each_source_once_into_a_hashed_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    assert _build.build() == ["gossip_mix", "lstm_forward", "lstm_train", "swa_attention"]
    lib = _build.library_path("lstm_forward")
    assert lib.parent == tmp_path / "kernels" and lib.name.startswith("lstm_forward-")
    assert lib.read_text() == "lib" and not list(lib.parent.glob("*.tmp"))
    assert _build.build() == []  # cached by the sources' hash


def test_build_failure_raises_with_the_log(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path, fail=True))
    with pytest.raises(RuntimeError, match="nvcc failed for lstm_forward"):
        _build.build(["lstm_forward"])
    assert not _build.library_path("lstm_forward").exists()


# ------------------------------------------------------------ the plan


def test_plan_path_depends_on_hidden_and_input_alone():
    """The cluster size and where the weights live (registers, shared
    memory or streamed) follow H and I; G and R only change the tile."""
    for hsz in (1, 8, 30, 64, 112, 113, 128, 160, 161, 256, 312, 313, 1000, lstm_cell.MAX_HIDDEN):
        for isz in (1, 3):
            paths = {lstm_cell._plan(g, r, steps, isz, hsz)[::2][:2]
                     for g in (1, 37, 64) for r in (1, 2, 9, 2034) for steps in (1, 12)}
            assert len(paths) == 1, (hsz, isz, paths)


def test_plan_tile_is_the_least_power_of_two_holding_r():
    tiles = {r: lstm_cell._plan(64, r, L, 1, 128).tile for r in (1, 2, 3, 4, 5, 8, 9, 329, 2034)}
    assert tiles == {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 8: 8, 9: 8, 329: 8, 2034: 8}
    assert lstm_cell._plan(1, 2034, L, 1, 400).tile == 1  # the streaming kernel: a block a row


def test_plan_cluster_is_the_smallest_that_fits():
    """Every H up to MAX_HIDDEN gets a launchable plan.  Shared-memory
    slices: C is the least of 1, 2, 4, 8 whose CTA fits a full tile's
    state in the opt-in limit, with one thread a gate column (at most
    512, the kernel's launch bound); H = 128 keeps a cluster of 2 with
    the weights in registers (256 threads); above C = 8's limit H
    streams."""
    limit, tile = lstm_cell.SMEM_LIMIT, lstm_cell.TILE
    seen = set()
    for hsz in range(1, lstm_cell.MAX_HIDDEN + 1):
        for isz in (1, 3):
            plan = lstm_cell._plan(1, 1, L, isz, hsz)
            fits = [c for c in lstm_cell.CLUSTERS
                    if lstm_cell._smem_bytes(hsz, isz, c, tile, "shared") <= limit]
            threads = -(-4 * -(-hsz // max(plan.cluster, 1)) // 32) * 32
            if plan.weights == "registers":
                assert (hsz, plan.cluster, threads) == (lstm_cell.REG_HIDDEN, 2, 256)
            elif plan.weights == "shared":
                assert plan.cluster == fits[0] and threads <= 512
                assert plan.smem == lstm_cell._smem_bytes(hsz, isz, plan.cluster, 1, "shared")
                assert lstm_cell._smem_bytes(hsz, isz, plan.cluster, tile, "shared") <= limit
            else:
                assert (plan.cluster, plan.weights, fits) == (0, "streamed", [])
                assert plan.smem == 6 * hsz * 4 <= 48 * 1024
            seen.add((plan.cluster, plan.weights))
    assert seen == {(1, "shared"), (2, "shared"), (4, "shared"), (8, "shared"),
                    (2, "registers"), (0, "streamed")}


def test_plan_regimes_at_the_documented_widths():
    """The widths the kernel's note and PERF.md name (I = 1)."""
    def path(hsz):
        plan = lstm_cell._plan(64, 1, L, 1, hsz)
        return plan.cluster, plan.weights

    assert path(8) == path(112) == (1, "shared")
    assert path(113) == path(127) == path(160) == (2, "shared")
    assert path(128) == (2, "registers")
    assert path(161) == path(224) == (4, "shared")
    assert path(225) == path(256) == path(312) == (8, "shared")
    assert path(313) == path(lstm_cell.MAX_HIDDEN) == (0, "streamed")

