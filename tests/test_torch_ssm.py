"""The port's Mamba-2 SSM family held against the JAX package on the CPU,
in fp32: the chunked ``ssd_forward`` against the sequential recurrence
h_t = exp(dt·A)·h_{t-1} + dt·B·x (float64) and against JAX's at atol
1e-5, over one, several and per-head B/C groups; ``ssd_decode_step``,
``mamba2_block`` and ``mamba2_decode`` on JAX's params; the block's
decode stepped over S against its forward; Mamba2-370M at reduced width
on JAX's weights carried across by ``arch.common.params_from_numpy``
(``forward``, ``loss_fn``, ``prefill`` and decode steps); and the
reference's prefill, which returns zero states, pinned in both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import ssm_lm as jssm_lm
from repro.config import get_arch_config as jax_arch_config
from repro.nn import ssm as jssm
from repro_torch.arch import ssm_lm
from repro_torch.arch.common import params_from_numpy
from repro_torch.config import get_arch_config
from repro_torch.nn import ssm

ATOL = 1e-5  # fp32 chunked SSD: the same sums in another order and grouping
LOGITS_ATOL = 1e-4  # fp32 logits after two layers
NAME = "mamba2-370m"


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _ssd_inputs(b, s, h, p, g, n, seed):
    """Inputs of the size a block gives the SSD: x, B, C ~ 0.5·N(0, 1),
    dt before its softplus ~ N(0, 1), A in -[e^-1, e], D ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((0.5 * rng.normal(size=(b, s, h, p))).astype(f32),
            rng.normal(size=(b, s, h)).astype(f32),
            -np.exp(rng.uniform(-1, 1, size=(h,))).astype(f32),
            (0.5 * rng.normal(size=(b, s, g, n))).astype(f32),
            (0.5 * rng.normal(size=(b, s, g, n))).astype(f32),
            rng.normal(size=(h,)).astype(f32))


def _sequential(x, dt, a_log, bm, cm, d_skip):
    """The recurrence itself, one position at a time, in float64."""
    x, dt, a_log, bm, cm, d_skip = (np.asarray(t, np.float64)
                                    for t in (x, dt, a_log, bm, cm, d_skip))
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    dt = np.log1p(np.exp(dt))
    state, ys = np.zeros((b, h, p, bm.shape[3])), []
    for t in range(s):
        bh, ch = np.repeat(bm[:, t], rep, axis=1), np.repeat(cm[:, t], rep, axis=1)
        state = (np.exp(dt[:, t] * a_log)[..., None, None] * state
                 + (x[:, t] * dt[:, t][..., None])[..., None] * bh[:, :, None, :])
        ys.append(np.einsum("bhpn,bhn->bhp", state, ch) + x[:, t] * d_skip[None, :, None])
    return np.stack(ys, 1), state


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 32, 4, 8, 1, 16, 8),    # one group shared by every head (Mamba2-370M's layout)
    (1, 64, 6, 4, 2, 8, 16),    # two groups of three heads
    (2, 16, 4, 4, 4, 4, 16),    # a group a head, one chunk
])
def test_ssd_forward_matches_sequential_recurrence_and_jax(b, s, h, p, g, n, chunk):
    inputs = _ssd_inputs(b, s, h, p, g, n, seed=s + g)
    y, state = ssm.ssd_forward(*map(torch.tensor, inputs), chunk=chunk)
    jy, jstate = jssm.ssd_forward(*map(jnp.asarray, inputs), chunk=chunk)
    want_y, want_state = _sequential(*inputs)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    _close(y, want_y)
    _close(state, want_state)
    _close(y, jy)
    _close(state, jstate)


def test_ssd_forward_keeps_fp32_inside_and_x_dtype_outside():
    inputs = [torch.tensor(t) for t in _ssd_inputs(1, 32, 4, 8, 1, 16, seed=5)]
    x16 = inputs[0].bfloat16()
    y, state = ssm.ssd_forward(x16, *inputs[1:], chunk=16)
    want, _ = ssm.ssd_forward(x16.float(), *inputs[1:], chunk=16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.equal(y, want.bfloat16())
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.ssd_forward(*inputs, chunk=24)


def test_ssd_decode_step_matches_jax():
    b, h, p, g, n = 2, 4, 8, 2, 16
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, p), (b, h), (h,), (b, g, n), (b, g, n), (h,), (b, h, p, n))]
    arrays[2] = -np.exp(arrays[2])
    y, state = ssm.ssd_decode_step(*map(torch.tensor, arrays))
    jy, jstate = jssm.ssd_decode_step(*map(jnp.asarray, arrays))
    _close(y, jy)
    _close(state, jstate)


DIMS = dict(expand=2, nheads=4, dstate=16)


def _block(d=32, seed=0):
    jp = jssm.init_mamba2_block(jax.random.PRNGKey(seed), d, **DIMS)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def test_mamba2_block_matches_jax():
    jp, p = _block()
    x = np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32)
    _close(ssm.mamba2_block(torch.tensor(x), p, chunk=8, **DIMS),
           jssm.mamba2_block(jnp.asarray(x), jp, chunk=8, **DIMS))


def test_mamba2_decode_stepped_over_s_matches_the_block():
    """Decode from the zero state, one position at a time, gives the
    block's forward at every position, in both packages, and the port's
    step agrees with JAX's (state included)."""
    jp, p = _block(seed=1)
    b, s, d = 2, 16, 32
    x = np.random.default_rng(1).normal(size=(b, s, d)).astype(np.float32)
    state = ssm.init_mamba2_state(b, d, **DIMS)
    jstate = jssm.init_mamba2_state(b, d, **DIMS)
    outs, jouts = [], []
    for t in range(s):
        out, state = ssm.mamba2_decode(torch.tensor(x[:, t]), p, state, **DIMS)
        jout, jstate = jssm.mamba2_decode(jnp.asarray(x[:, t]), jp, jstate, **DIMS)
        outs.append(out)
        jouts.append(jout)
    _close(torch.stack(outs, 1), ssm.mamba2_block(torch.tensor(x), p, chunk=8, **DIMS))
    _close(jnp.stack(jouts, 1), jssm.mamba2_block(jnp.asarray(x), jp, chunk=8, **DIMS))
    _close(torch.stack(outs, 1), jnp.stack(jouts, 1))
    _close(state["ssm"], jstate["ssm"])
    _close(state["conv"], jstate["conv"])


def _pair():
    jcfg, cfg = jax_arch_config(NAME).reduced(), get_arch_config(NAME).reduced()
    jparams = jssm_lm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_reduced_mamba2_matches_jax():
    jcfg, cfg, jparams, params = _pair()
    tokens, labels = _tokens(cfg, 2, 32, 1), _tokens(cfg, 2, 32, 2)
    tb = {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)}
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits, aux = ssm_lm.forward(params, cfg, tb)
    jlogits, jaux = jssm_lm.forward(jparams, jcfg, jb)
    assert logits.shape == jlogits.shape
    _close(logits, jlogits, LOGITS_ATOL)
    _close(aux, jaux)
    _close(ssm_lm.loss_fn(params, cfg, tb), jssm_lm.loss_fn(jparams, jcfg, jb), LOGITS_ATOL)
    last, state = ssm_lm.prefill(params, cfg, tb)
    jlast, jstate = jssm_lm.prefill(jparams, jcfg, jb)
    _close(last, jlast, LOGITS_ATOL)
    _close(last, logits[:, -1:], LOGITS_ATOL)
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: v.shape for k, v in jstate.items()}
    assert state["ssm"].dtype == torch.float32 and state["conv"].dtype == torch.float32
    for t in range(3):
        tok = tokens[:, t:t + 1]
        step, state = ssm_lm.decode_step(params, cfg, state, {"token": torch.tensor(tok), "pos": t})
        jstep, jstate = jssm_lm.decode_step(jparams, jcfg, jstate,
                                            {"token": jnp.asarray(tok), "pos": jnp.asarray(t)})
        _close(step, jstep, LOGITS_ATOL)
        _close(step, logits[:, t:t + 1], LOGITS_ATOL)  # decode from zeros reads tokens 0, 1, ...


def test_prefill_returns_zero_states_of_the_reference_is_pinned():
    """Pin of a reference oddity (``repro.arch.ssm_lm.prefill``): the
    states it returns are ``init_state``'s zeros, not the prompt's, so a
    decode step after a prefill of S tokens equals the first step of an
    empty context, not ``forward`` at position S.  Both packages do so."""
    jcfg, cfg, jparams, params = _pair()
    tokens = _tokens(cfg, 1, 48, 3)  # a whole number of chunks; position 32 reads 0..32
    prompt, nxt = tokens[:, :32], tokens[:, 32:33]
    _, state = ssm_lm.prefill(params, cfg, {"tokens": torch.tensor(prompt)})
    _, jstate = jssm_lm.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    assert not any(bool(v.any()) for v in state.values())
    assert not any(bool(jnp.any(v)) for v in jstate.values())
    step, _ = ssm_lm.decode_step(params, cfg, state, {"token": torch.tensor(nxt), "pos": 32})
    jstep, _ = jssm_lm.decode_step(jparams, jcfg, jstate,
                                   {"token": jnp.asarray(nxt), "pos": jnp.asarray(32)})
    _close(step, jstep, LOGITS_ATOL)
    fresh, _ = ssm_lm.decode_step(params, cfg, ssm_lm.init_state(cfg, 1, "cpu"),
                                  {"token": torch.tensor(nxt), "pos": 0})
    assert torch.equal(step, fresh)
    full, _ = ssm_lm.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    assert float((step - full[:, 32:33]).abs().max()) > 1e-2


def test_init_params_shapes_and_dtype():
    cfg = dataclasses.replace(get_arch_config(NAME).reduced(), dtype="bfloat16")
    jtree = jax.eval_shape(lambda k: jssm_lm.init_params(k, cfg), jax.random.PRNGKey(0))
    params = ssm_lm.init_params(torch.Generator().manual_seed(0), cfg)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    want = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in flat}
    got = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}['{key}']")
            else:
                assert val.dtype == torch.bfloat16
                got[f"{prefix}['{key}']"] = tuple(val.shape)

    walk(params, "")
    assert got == want
    a_log = params["layers"]["mamba"]["a_log"].float()
    assert bool((a_log < -np.exp(-1) * 0.99).all()) and bool((a_log > -np.e * 1.01).all())
