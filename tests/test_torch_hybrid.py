"""The port's RG-LRU hybrid family held against the JAX package on the
CPU: the causal conv, ``linear_scan`` against a sequential recurrence,
``rglru_forward`` / ``rglru_decode_step`` / ``recurrent_block`` on JAX's
params from numpy inputs (fp32, atol 1e-5), ``recurrent_block_decode``
stepped over S positions against ``recurrent_block`` in both packages,
and RecurrentGemma-9B at reduced width on JAX's weights carried across
by ``arch.common.params_from_numpy``: ``forward``, ``loss_fn`` and
``prefill`` with hd 256, one KV head and a 1024-token window at S=3072
(the banded branch, so the kernel's twin), decode past the window's 64
slots (the ring wraps) against JAX and against ``forward``, and the
reference's decode capacity min(seq_len, window) pinned in both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import build_arch as jax_build_arch
from repro.arch import hybrid_lm as jhybrid
from repro.config import get_arch_config as jax_arch_config
from repro.nn import rglru as jrglru
from repro.nn.ssm import _causal_conv as jax_causal_conv
from repro_torch.arch import build_arch
from repro_torch.arch import hybrid_lm
from repro_torch.arch.common import params_from_numpy
from repro_torch.config import get_arch_config
from repro_torch.nn import attention as tattn
from repro_torch.nn import rglru
from repro_torch.nn.ssm import causal_conv

ATOL = 1e-5  # fp32 block outputs: the same function, sums and the scan in another order
LOGITS_ATOL = 1e-4  # fp32 logits after a super-block (three layers)
NAME = "recurrentgemma-9b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _numpy(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_numpy(got), _numpy(want), rtol=0, atol=atol)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_causal_conv_matches_jax():
    u, w, b = _x((2, 9, 6), 0), _x((4, 6), 1), _x((6,), 2)
    _close(causal_conv(*map(torch.tensor, (u, w, b))), jax_causal_conv(*map(jnp.asarray, (u, w, b))))


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_linear_scan_is_the_sequential_recurrence(s):
    a = torch.tensor(np.random.default_rng(s).uniform(0.5, 1.0, (2, s, 5)).astype(np.float32))
    b = torch.tensor(_x((2, s, 5), s + 1))
    a0, b0 = a.clone(), b.clone()
    h, want = torch.zeros(2, 5), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, dim=1), 1e-6)
    assert torch.equal(a, a0) and torch.equal(b, b0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_forward_and_decode_step_match_jax(with_h0):
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), 16)
    p = _torch_tree(_np_tree(jp))
    x, h0 = _x((2, 23, 16), 4), _x((2, 16), 5)
    kw_j = {"h0": jnp.asarray(h0)} if with_h0 else {}
    kw_t = {"h0": torch.tensor(h0)} if with_h0 else {}
    y, h_last = rglru.rglru_forward(torch.tensor(x), p, **kw_t)
    jy, jh_last = jrglru.rglru_forward(jnp.asarray(x), jp, **kw_j)
    _close(y, jy)
    _close(h_last, jh_last)
    assert h_last.dtype == torch.float32
    y_t, h_new = rglru.rglru_decode_step(torch.tensor(x[:, 0]), p, torch.tensor(h0))
    jy_t, jh_new = jrglru.rglru_decode_step(jnp.asarray(x[:, 0]), jp, jnp.asarray(h0))
    _close(y_t, jy_t)
    _close(h_new, jh_new)


def test_rglru_gates_follow_jax_types_in_bf16():
    """bf16 weights (as after ``cast_params``): the gates' products in
    fp32 on the weights cast up, softplus(lam) in bf16, y back in bf16."""
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jrglru.init_rglru(jax.random.PRNGKey(6), 16))
    p = {k: torch.tensor(np.asarray(v, np.float32)).bfloat16() for k, v in jp.items()}
    x = _x((1, 12, 16), 7)
    y, h_last = rglru.rglru_forward(torch.tensor(x).bfloat16(), p)
    jy, jh_last = jrglru.rglru_forward(jnp.asarray(x, jnp.bfloat16), jp)
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    _close(h_last, jh_last, 1e-5)
    _close(y, jnp.asarray(jy, jnp.float32), 2 ** -8)  # one bf16 rounding of |y| < 2


def test_recurrent_block_matches_jax():
    jp = jrglru.init_recurrent_block(jax.random.PRNGKey(8), 24, 16)
    p = _torch_tree(_np_tree(jp))
    x = _x((2, 19, 24), 9)
    _close(rglru.recurrent_block(torch.tensor(x), p), jrglru.recurrent_block(jnp.asarray(x), jp))


def test_recurrent_block_decode_stepped_equals_the_block_in_both_packages():
    jp = jrglru.init_recurrent_block(jax.random.PRNGKey(10), 24, 16)
    p = _torch_tree(_np_tree(jp))
    x = _x((2, 21, 24), 11)
    state = rglru.init_recurrent_state(2, 16)
    jstate = jrglru.init_recurrent_state(2, 16)
    outs, jouts = [], []
    for t in range(x.shape[1]):
        out, state = rglru.recurrent_block_decode(torch.tensor(x[:, t]), p, state)
        jout, jstate = jrglru.recurrent_block_decode(jnp.asarray(x[:, t]), jp, jstate)
        outs.append(out)
        jouts.append(jout)
    _close(torch.stack(outs, dim=1), rglru.recurrent_block(torch.tensor(x), p))
    _close(jnp.stack(jouts, axis=1), jrglru.recurrent_block(jnp.asarray(x), jp))
    _close(torch.stack(outs, dim=1), jnp.stack(jouts, axis=1))
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])


# ---------------------------------------------------------------- the model


def _pair(**changes):
    """(JAX, port) configs of the reduced RecurrentGemma-9B, JAX's params
    from PRNGKey(0), and the same params as the port's tree on the CPU."""
    jcfg = dataclasses.replace(jax_arch_config(NAME).reduced(), **changes)
    cfg = dataclasses.replace(get_arch_config(NAME).reduced(), **changes)
    jparams = jhybrid.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(_np_tree(jparams), cfg, "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_build_arch_gives_the_hybrid_and_its_tree_mirrors_jax():
    cfg = dataclasses.replace(get_arch_config(NAME).reduced(), dtype="bfloat16")
    arch = build_arch(cfg)
    assert arch.supports("long_500k") and arch.supports_long
    assert hybrid_lm.num_super_blocks(get_arch_config(NAME)) == 13
    assert hybrid_lm.num_super_blocks(cfg) == 1
    jtree = jax.eval_shape(lambda k: jhybrid.init_params(k, cfg), jax.random.PRNGKey(0))
    params = arch.init_params(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {}

    def walk(tree, key):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{key}['{k}']")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{key}[{i}]")
        else:
            assert tree.dtype == torch.bfloat16, key
            got[key] = tuple(tree.shape)

    walk(params, "")
    assert got == want
    assert not params["blocks"][0]["ln1_scale"].any()
    lam = params["blocks"][1]["mix"]["rec"]["rglru"]["lam"].float()
    assert float(lam.min()) >= 0.29 and float(lam.max()) <= 0.81


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_hybrid_input_specs_match_jax(shape):
    mine = build_arch(get_arch_config(NAME)).input_specs(shape, override_batch=2)
    theirs = jax_build_arch(jax_arch_config(NAME)).input_specs(shape, override_batch=2)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in theirs.items()}


def test_banded_forward_loss_and_prefill_match_jax_at_hd256():
    """hd 256, one KV head, a 1024-token window at S=3072: the attention
    block takes the banded branch (the kernel's place; on the CPU its
    twin), once in ``forward`` and once in ``prefill``."""
    jcfg, cfg, jparams, params = _pair(head_dim=256, num_kv_heads=1, local_attn_window=1024)
    toks = _tokens(cfg, 1, 3072, seed=12)
    labels = np.random.default_rng(13).integers(-1, cfg.vocab_size, (1, 3072)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    before = dict(tattn.BRANCHES)
    tl, aux = hybrid_lm.forward(params, cfg, tb)
    jl, jaux = jhybrid.forward(jparams, jcfg, jb)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    _close(tl, jl, LOGITS_ATOL)
    _close(aux, jaux)
    arch, jarch = build_arch(cfg), jax_build_arch(jcfg)
    got, state = arch.prefill_fn(params, tb)
    want, _ = jarch.prefill_fn(jparams, jb)
    assert state is None and got.shape == want.shape == (1, 1, tl.shape[-1])
    _close(got, want, LOGITS_ATOL)
    taken = {k: tattn.BRANCHES[k] - before[k] for k in before}
    assert taken == {"plain": 0, "flash": 0, "banded": 2, "banded_grad": 0}
    # the loss from the port's logits, against JAX's loss_fn
    _close(hybrid_lm.loss_fn(params, cfg, tb), jhybrid.loss_fn(jparams, jcfg, jb), LOGITS_ATOL)


def _decode_both(jcfg, cfg, jparams, params, toks, seq_len):
    """Greedy-free decode of ``toks`` (B, T) from ``init_state(seq_len)``
    on both sides (JAX's step jitted); returns the stacked logits."""
    arch, jarch = build_arch(cfg), jax_build_arch(jcfg)
    state = arch.init_decode_state(params, toks.shape[0], seq_len)
    jstate = jarch.init_decode_state(jparams, toks.shape[0], seq_len)
    jstep = jax.jit(jarch.decode_fn)
    got, want = [], []
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        logits, state = arch.decode_fn(params, state, {"token": torch.tensor(tok), "pos": t})
        jlogits, jstate = jstep(jparams, jstate, {"token": jnp.asarray(tok),
                                                  "pos": jnp.asarray(t, jnp.int32)})
        got.append(logits[:, 0])
        want.append(np.asarray(jlogits)[:, 0])
    assert int(state["kv2"].pos[0]) == toks.shape[1]
    return torch.stack(got, dim=1), np.stack(want, axis=1), state, jstate


def test_decode_wraps_the_ring_and_matches_jax_and_forward():
    """80 steps through a ring of 64 slots (the reduced window): every
    step within 1e-4 of JAX's, and of ``forward`` at that position (the
    ring holds exactly the window's keys)."""
    jcfg, cfg, jparams, params = _pair()
    toks = _tokens(cfg, 2, 80, seed=14)
    got, want, state, jstate = _decode_both(jcfg, cfg, jparams, params, toks, seq_len=80)
    assert state["kv2"].k.shape == (1, 2, 64, cfg.num_kv_heads, cfg.head_dim)
    _close(got, want, LOGITS_ATOL)
    _close(got, hybrid_lm.forward(params, cfg, {"tokens": torch.tensor(toks)})[0], LOGITS_ATOL)
    _close(state["kv2"].k, jstate["kv2"].k)
    _close(state["rec0"]["h"], jstate["rec0"]["h"])
    _close(state["rec1"]["conv"], jstate["rec1"]["conv"])


def test_decode_capacity_of_the_reference_is_pinned():
    """Pin of the reference's ``init_state`` capacity (``repro.arch.
    hybrid_lm.init_state``): the ring holds min(seq_len, window) slots,
    so decoding past seq_len < window keeps only the last seq_len keys
    in view.  Both packages agree step for step; both follow ``forward``
    up to seq_len and leave it after.  The port keeps the reference's
    semantics (ROADMAP Queue 3)."""
    jcfg, cfg, jparams, params = _pair()
    toks = _tokens(cfg, 1, 28, seed=15)
    got, want, state, _ = _decode_both(jcfg, cfg, jparams, params, toks, seq_len=16)
    assert state["kv2"].k.shape[2] == 16
    _close(got, want, LOGITS_ATOL)
    fwd = hybrid_lm.forward(params, cfg, {"tokens": torch.tensor(toks)})[0]
    jfwd = np.asarray(jhybrid.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})[0])
    _close(got[:, :16], fwd[:, :16], LOGITS_ATOL)
    gap = float((got[:, 16:] - fwd[:, 16:]).abs().max())
    jgap = float(np.abs(want[:, 16:] - jfwd[:, 16:]).max())
    assert gap > 1e-2 and jgap > 1e-2


def test_arch_demo_decodes_the_hybrid_on_the_cpu(capsys):
    from repro_torch.launch import arch_demo

    assert arch_demo.main(["--device", "cpu", "--arch", NAME, "--batch", "1",
                           "--prompt-len", "4", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={NAME}-smoke family=hybrid L=2 d=256" in out
    assert "decoded 3 tokens" in out and "sampled token ids: [[" in out
