"""The LM zoo's train step in the port (``repro_torch.arch.common``:
``TrainState``, ``init_train_state``, ``adam_apply``,
``make_train_step``) held against the JAX package's on the CPU, and the
decode state's specs against JAX's ``eval_shape``.

One ``.reduced()`` config per family (dense, MoE, VLM, SSM, hybrid,
enc-dec; fp32, 2 layers), B=2, S=32, random int tokens and labels from a
numpy seed (constant tokens hit the MoE's pinned tie oddity), the same
params carried across as fp32 masters by ``params_from_numpy``.  JAX's
jitted step and the port's run at M=1 and M=2 microbatches:

  * step 1 from the same initial state; step 2 from JAX's state after
    step 1 on both sides.  Adam's first step is about ``lr · sign(g)``,
    so an element whose gradient is rounding noise may move by up to
    2·lr on one side and not the other; chained, those few elements
    change the second step's gradients by ~1e-4 of a leaf's max, which
    is the optimizer's sensitivity, not the port's.  Each step is
    therefore held from the same state;
  * loss and ``grad_norm`` within 1e-5 relative; m and v within 1e-5
    of each leaf's largest |value| (the gradients' parity); ``step``
    equal; params within ``lr · 1e-3`` wherever the step's RMS
    sqrt(v / (1 - b2^k)) exceeds ``RMS_FLOOR[k]`` and within ``2 · lr``
    elsewhere.  At step 1 that RMS is |g|, and the floor 1e-6 is where
    g is rounding noise and ``lr · sign(g)`` may flip.  At step 2 the
    update ``lr · m̂ / sqrt(v̂)`` moves by ``lr · δ / sqrt(v̂)`` for a
    gradient difference δ, which summation order alone makes 1e-9 to
    4e-8 here (one dense config's ``wo`` element: m̂ = 2.0e-5,
    sqrt(v̂) = 3.5e-5, update off by 0.7 of ``lr · 1e-3``), so its floor
    is 1e-4.

Also: ``adam_apply`` alone on random trees over several steps (its bias
correction within 1e-6), ``decode_state_specs`` shapes and dtypes of
every registered LM config reduced and of one full config at
``decode_32k`` against
JAX's ``eval_shape``, every family's loss differentiable, and the
Mamba-2 SSD's numbers unmoved by the autograd-safe inter-chunk loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.arch import build_arch as jax_build_arch
from repro.arch.common import TrainState as JaxTrainState
from repro.arch.common import adam_apply as jax_adam_apply
from repro.arch.common import init_train_state as jax_init_train_state
from repro.arch.common import make_train_step as jax_make_train_step
from repro.config import get_arch_config as jax_arch_config
from repro.config import list_archs as jax_list_archs
from repro_torch.arch import build_arch
from repro_torch.arch.api import TrainState, init_train_state, make_train_step
from repro_torch.arch.common import adam_apply, params_from_numpy
from repro_torch.config import get_arch_config
from repro_torch.nn import attention as tattn
from repro_torch.nn import ssm
from repro_torch.nn.attention import KVCache
from repro_torch.utils.pytree import tree_leaves

FAMILIES = ["yi-6b", "mixtral-8x22b", "llava-next-mistral-7b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-medium"]
LR = 1e-3
B, S = 2, 32
REL = 1e-5           # loss and grad_norm, relative
MOMENT_REL = 1e-5    # m and v, of each leaf's largest |value|
RMS_FLOOR = {1: 1e-6, 2: 1e-4}  # the step's sqrt(v-hat) above which params hold to lr·1e-3
B2 = 0.95


@pytest.fixture(autouse=True)
def one_thread():
    """Small eager ops on one thread: with several test workers sharing
    the cores, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(name):
    jcfg, cfg = jax_arch_config(name).reduced(), get_arch_config(name).reduced()
    jarch, arch = jax_build_arch(jcfg), build_arch(cfg)
    jparams = jarch.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(7)
    arrays = {}
    for key, spec in jarch.input_specs("train_4k", override_batch=B, override_seq=S).items():
        if spec.dtype == jnp.int32:
            lo = -1 if key == "labels" else 0
            arrays[key] = rng.integers(lo, cfg.vocab_size, spec.shape).astype(np.int32)
        else:
            arrays[key] = rng.normal(size=spec.shape).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.tensor(v) for k, v in arrays.items()}
    return jarch, arch, jparams, params, jb, tb


def _to_port(jstate) -> TrainState:
    """JAX's train state as the port's (fp32 leaves, int32 step)."""
    def tree(t):
        return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), t)
    return TrainState(params=jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(),
                                          jstate.params),
                      m=tree(jstate.m), v=tree(jstate.v),
                      step=torch.tensor(np.asarray(jstate.step)))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _check_step(jnew, jmetrics, new, metrics, k, what):
    for key in ("loss", "grad_norm"):
        want, got = float(jmetrics[key]), float(metrics[key])
        assert abs(got - want) <= REL * abs(want), (what, key, got, want)
    assert int(new.step) == int(jnew.step), what
    assert new.step.dtype == torch.int32
    for field in ("m", "v"):
        for want, got in zip(jax.tree.leaves(getattr(jnew, field)),
                             tree_leaves(getattr(new, field))):
            want, got = np.asarray(want), _np(got)
            assert got.shape == want.shape and got.dtype == np.float32, (what, field)
            err = np.abs(got - want).max()
            assert err <= MOMENT_REL * max(np.abs(want).max(), 1e-30), (what, field, err)
    for want, got, v in zip(jax.tree.leaves(jnew.params), tree_leaves(new.params),
                            jax.tree.leaves(jnew.v)):
        want, got = np.asarray(want), _np(got)
        assert got.dtype == np.float32
        err = np.abs(got - want)
        signal = np.sqrt(np.asarray(v) / (1 - B2 ** k)) > RMS_FLOOR[k]
        assert (err[signal] <= LR * 1e-3).all(), (what, err[signal].max())
        assert (err <= 2 * LR).all(), (what, err.max())


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name, mb):
    jarch, arch, jparams, params, jb, tb = _setup(name)
    jstep = jax.jit(jax_make_train_step(jarch.loss_fn, num_microbatches=mb, lr=LR))
    step = make_train_step(arch.loss_fn, num_microbatches=mb, lr=LR, data_axes=("data",))
    jstate, state = jax_init_train_state(jparams), init_train_state(params)
    assert all(leaf.requires_grad and leaf.dtype == torch.float32
               for leaf in tree_leaves(state.params))
    for k in (1, 2):
        jnew, jmetrics = jstep(jstate, jb)
        new, metrics = step(state, tb)
        _check_step(jnew, jmetrics, new, metrics, k, f"{name} M={mb} step {k}")
        jstate, state = jnew, _to_port(jnew)
    # the given state is not changed by a step, and every leaf moved
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(new.params)))


def test_adam_apply_matches_jax_over_several_steps():
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    tree = {"a": rng.normal(size=shapes["a"]).astype(np.float32),
            "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]}
    jstate = jax_init_train_state(jax.tree.map(jnp.asarray, tree))
    state = init_train_state(jax.tree.map(torch.tensor, tree))
    for k in range(6):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -k, tree)
        jstate = jax_adam_apply(jstate, jax.tree.map(jnp.asarray, g), lr=1e-2)
        state = adam_apply(state, jax.tree.map(torch.tensor, g), lr=1e-2)
        assert int(state.step) == k + 1
        # bias corrections 1 - b ** step, each side's own
        for b in (0.9, 0.95):
            want = 1 - np.float32(b) ** np.float32(k + 1)
            got = float(1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                                      state.step.to(torch.float32)))
            assert abs(got - want) <= 1e-6
        for field in ("params", "m", "v"):
            for want, got in zip(jax.tree.leaves(getattr(jstate, field)),
                                 tree_leaves(getattr(state, field))):
                np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert all(leaf.requires_grad for leaf in tree_leaves(state.params))


def _spec_tree(tree):
    """(shape, dtype name) of every leaf, KVCaches as dicts."""
    if dataclasses.is_dataclass(tree):  # the KVCache of either package
        return {f: _spec_tree(getattr(tree, f)) for f in ("k", "v", "pos")}
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("name,shape,reduced",
                         [(n, "decode_32k", True) for n in jax_list_archs() if n != "glucose-lstm"]
                         + [("whisper-medium", "decode_32k", False)])
def test_decode_state_specs_match_jax_eval_shape(name, shape, reduced):
    jcfg, cfg = jax_arch_config(name), get_arch_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    kw = dict(override_batch=2, override_seq=128) if reduced else {}
    want = jax_build_arch(jcfg).decode_state_specs(shape, **kw)
    got = build_arch(cfg).decode_state_specs(shape, **kw)
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _spec_tree(got) == _spec_tree(want)


def _leaves(tree):
    if isinstance(tree, KVCache):
        return [tree.k, tree.v, tree.pos]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_loss_is_differentiable_and_serving_is_unchanged(name):
    """Each family's loss from fp32 masters, cast to bf16 at the
    forward's entry, reaches every leaf with a nonzero gradient; the
    serving dtype (``init_params`` with no dtype) stays ``cfg.dtype``."""
    cfg = dataclasses.replace(get_arch_config(name).reduced(), dtype="bfloat16")
    arch = build_arch(cfg)
    gen = torch.Generator().manual_seed(0)
    assert {leaf.dtype for leaf in tree_leaves(arch.init_params(gen))} == {torch.bfloat16}
    masters = init_train_state(arch.init_params(gen, torch.float32)).params
    assert {leaf.dtype for leaf in tree_leaves(masters)} == {torch.float32}
    batch = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape), generator=gen, dtype=torch.int32)
                 if v.dtype == torch.int32 else torch.randn(tuple(v.shape), generator=gen))
             for k, v in arch.input_specs("train_4k", override_batch=1, override_seq=16).items()}
    loss = arch.loss_fn(masters, batch)
    grads = torch.autograd.grad(loss, tree_leaves(masters), allow_unused=True)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)


def _ssd_before_the_rewrite(x, dt, a_log, bm, cm, d_skip, chunk):
    """``nn.ssm._ssd_forward`` as it was before its inter-chunk loop
    became autograd-safe: ``prev`` written with ``addcmul(..., out=)``."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, q, rep = s // chunk, chunk, h // g
    dt = F.softplus(dt.float())
    a = dt * a_log.float()[None, None, :]
    xdt = x.float() * dt[..., None]
    xc = xdt.reshape(b, nc, q, g, rep, p).permute(0, 1, 3, 4, 2, 5)
    ac = a.reshape(b, nc, q, h).permute(0, 3, 1, 2)
    bc = bm.float().reshape(b, nc, q, g, n).transpose(2, 3)
    cc = cm.float().reshape(b, nc, q, g, n).transpose(2, 3)
    decay = torch.exp(ssm._segsum(ac)).permute(0, 2, 1, 3, 4)
    scores = (cc @ bc.transpose(-1, -2))[:, :, :, None] * decay.reshape(b, nc, g, rep, q, q)
    y_diag = scores @ xc
    a_cum = torch.cumsum(ac, dim=-1)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 1, 3)
    xd = xc * decay_states.reshape(b, nc, g, rep, q, 1)
    states = xd.transpose(-1, -2).reshape(b, nc, g, rep * p, q) @ bc
    states = states.reshape(b, nc, h, p, n)
    chunk_decay = torch.exp(a_cum[..., -1]).permute(2, 0, 1)
    prev = torch.empty((nc + 1, b, h, p, n), dtype=torch.float32, device=x.device)
    prev[0] = 0.0
    for c in range(nc):
        torch.addcmul(states[:, c], chunk_decay[c][..., None, None], prev[c], out=prev[c + 1])
    hp = prev[:nc].permute(1, 0, 2, 3, 4).reshape(b, nc, g, rep * p, n)
    y_off = (cc @ hp.transpose(-1, -2)).reshape(b, nc, g, q, rep, p)
    state_decay = torch.exp(a_cum).permute(0, 2, 1, 3).reshape(b, nc, g, rep, q)
    y_off = y_off * state_decay.transpose(-1, -2)[..., None]
    y = y_diag.permute(0, 1, 4, 2, 3, 5) + y_off.transpose(2, 3)
    y = y.reshape(b, s, h, p) + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), prev[nc]


def test_mamba2_prefill_numbers_did_not_move(monkeypatch):
    cfg = get_arch_config("mamba2-370m").reduced()
    arch = build_arch(cfg)
    params = arch.init_params(torch.Generator().manual_seed(5))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(6))
    logits, _ = arch.prefill_fn(params, {"tokens": tokens})
    monkeypatch.setattr(ssm, "_ssd_forward", _ssd_before_the_rewrite)
    before, _ = arch.prefill_fn(params, {"tokens": tokens})
    assert torch.equal(logits, before)


def test_gqa_attention_banded_grad_branch_equals_banded_flash_attention():
    """Under autograd the banded shape takes the plain
    ``banded_flash_attention`` (``flash_threshold`` and ``block`` lowered
    to reach it at a small S): its output and q, k, v gradients are
    ``banded_flash_attention``'s bitwise; without grad the same call
    counts a ``banded`` branch."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 256, h, 16), generator=gen) for h in (4, 2, 2))
    kw = dict(window=64, block=32)
    before = dict(tattn.BRANCHES)
    with torch.no_grad():
        tattn.gqa_attention(q, k, v, causal=True, flash_threshold=64, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.gqa_attention(*leaves, causal=True, flash_threshold=64, **kw)
    taken = {kind: tattn.BRANCHES[kind] - before[kind] for kind in before}
    assert taken == {"plain": 0, "flash": 0, "banded": 1, "banded_grad": 1}
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.banded_flash_attention(*ref_leaves, **kw)
    assert torch.equal(out, ref)
    cot = torch.randn(out.shape, generator=gen)
    for got, want in zip(torch.autograd.grad(out, leaves, cot),
                         torch.autograd.grad(ref, ref_leaves, cot)):
        assert torch.equal(got, want)


def test_train_state_has_jax_fields():
    assert list(JaxTrainState.__dataclass_fields__) == list(TrainState.__dataclass_fields__)
