"""The port's mixture-of-experts FFN (``repro_torch.nn.moe``) held against
``repro.nn.moe`` on the CPU, on JAX's params carried across as numpy, in
fp32: the output and both aux losses at atol 1e-5 with and without
dropped tokens, the expert-side choice against ``jax.lax.top_k`` where
priorities tie (ties go to the lower token index), a zero router over a
constant prompt where every priority ties, the reference's routing to
more than k experts under token-side ties, two runs bitwise equal, and
Mixtral at reduced width through the banded branch (a 1024-token window
at S=3072) against JAX.  The dense-path checks of the MoE configs
(forward, loss with the aux terms, prefill and decode) run in
``tests/test_torch_arch.py`` beside the dense ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import lm as jlm
from repro.config import get_arch_config as jax_arch_config
from repro.nn import moe as jmoe
from repro_torch.arch import lm
from repro_torch.arch.common import params_from_numpy
from repro_torch.config import get_arch_config
from repro_torch.nn import attention as tattn
from repro_torch.nn import moe

ATOL = 1e-5  # fp32 expert MLPs: the same GEMMs, sums in another order
LOGITS_ATOL = 1e-4  # fp32 logits after two layers


def _jax_moe(d, ff, e, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=atol)


def _both(x, jp, p, **kw):
    out, aux = moe.moe_ffn(torch.tensor(x), p, **kw)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, **kw)
    return (out, aux), (jout, jaux)


@pytest.mark.parametrize("b,s,e,k,cf", [
    (2, 24, 4, 2, 1.25), (1, 40, 8, 2, 1.25),  # Mixtral's routing, reduced and full E
    (2, 32, 32, 8, 1.25),                      # Granite's: 32 experts, top 8
    (2, 24, 4, 2, 0.5),                        # a capacity that drops tokens
    (2, 1, 4, 2, 1.25)])                       # decode: capacity 1, every expert runs
def test_moe_ffn_matches_jax(b, s, e, k, cf):
    d, ff = 32, 48
    jp, p = _jax_moe(d, ff, e)
    x = np.random.default_rng(s).normal(size=(b, s, d)).astype(np.float32)
    (out, aux), (jout, jaux) = _both(x, jp, p, top_k=k, capacity_factor=cf)
    assert out.shape == (b, s, d) and out.dtype == torch.float32
    _close(out, jout)
    for name in ("load_balance", "router_z"):
        _close(aux[name], jaux[name])
    if cf < 1:  # some token lost every expert it was routed to
        assert moe.capacity(s, k, e, cf) == 6
        assert int((out.abs().sum(-1) == 0).sum()) > 0
        np.testing.assert_array_equal((out.abs().sum(-1) == 0).numpy(),
                                      np.asarray(jnp.abs(jout).sum(-1) == 0))
    again, _ = moe.moe_ffn(torch.tensor(x), p, top_k=k, capacity_factor=cf)
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,s,e,cap,levels", [(1, 3000, 4, 1250, 5), (2, 64, 8, 20, 3)])
def test_expert_choice_breaks_ties_as_jax_top_k(b, s, e, cap, levels):
    """Priorities on a few levels, so that most tie: the kept tokens and
    their order are ``jax.lax.top_k``'s, the lower index first."""
    routed = (np.random.default_rng(cap).integers(0, levels, (b, s, e)) / levels).astype(np.float32)
    vals, idx = moe.expert_choice(torch.tensor(routed), cap)
    jvals, jidx = jax.lax.top_k(jnp.swapaxes(jnp.asarray(routed), 1, 2), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_zero_router_over_a_constant_prompt_keeps_jax_tokens():
    """Every logit 0, so every expert ties with the k-th and takes 1/E,
    and every token's priority ties: each expert keeps the first C
    tokens, the rest are dropped by all, in both packages."""
    b, s, d, e, k, cf = 1, 40, 16, 4, 2, 0.5
    jp, p = _jax_moe(d, 24, e)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    p = {**p, "router": torch.zeros_like(p["router"])}
    row = np.random.default_rng(0).normal(size=(1, 1, d))
    x = np.broadcast_to(row, (b, s, d)).astype(np.float32)
    (out, aux), (jout, jaux) = _both(x, jp, p, top_k=k, capacity_factor=cf)
    cap = moe.capacity(s, k, e, cf)
    assert cap == 10
    _close(out, jout)
    kept = out.abs().sum(-1)[0] > 0
    assert kept[:cap].all() and not kept[cap:].any()
    # all E experts routed (ties with the k-th): ce = E / k each, so E * E / k
    _close(aux["load_balance"], jaux["load_balance"])
    assert float(aux["load_balance"]) == pytest.approx(e * e / k)


def test_token_side_ties_route_to_more_than_k_experts_in_both():
    """The reference keeps every expert whose probability equals the
    k-th (``probs >= kth``), so tied experts all take a share; the port
    does the same (ROADMAP Queue 3)."""
    d, e, k = 8, 4, 2
    jp, p = _jax_moe(d, 16, e)
    router = np.zeros((d, e), np.float32)
    router[0] = [1.0, 0.0, 0.0, 0.0]  # x[0] > 0: expert 0 first, experts 1-3 tie
    jp, p = {**jp, "router": jnp.asarray(router)}, {**p, "router": torch.tensor(router)}
    x = np.zeros((1, 1, d), np.float32)
    x[0, 0, 0] = 2.0
    probs = torch.softmax(torch.tensor(x) @ torch.tensor(router), -1)
    kth = torch.topk(probs, k).values[..., -1:]
    assert int((probs >= kth).sum()) == e  # four experts routed where k is 2
    (out, aux), (jout, jaux) = _both(x, jp, p, top_k=k, capacity_factor=1.25)
    _close(out, jout)
    _close(aux["load_balance"], jaux["load_balance"])


def test_mixtral_banded_prefill_and_decode_match_jax():
    """Mixtral at reduced width with a 1024-token window at S=3072: the
    attention of every layer takes the banded branch (the kernel's place;
    on the CPU its twin) and the MoE dispatches 1,920 tokens an expert."""
    name = "mixtral-8x22b"
    jcfg = dataclasses.replace(jax_arch_config(name).reduced(), sliding_window=1024)
    cfg = dataclasses.replace(get_arch_config(name).reduced(), sliding_window=1024)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 3072)).astype(np.int32)
    before = dict(tattn.BRANCHES)
    tlog, tcache = lm.prefill(params, cfg, {"tokens": torch.tensor(tokens)})
    jlog, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    taken = {kind: tattn.BRANCHES[kind] - before[kind] for kind in before}
    assert taken == {"plain": 0, "flash": 0, "banded": cfg.num_layers, "banded_grad": 0}
    _close(tlog, jlog, LOGITS_ATOL)
    _close(tcache.k, jcache.k)
    for t in range(3):  # S % window == 0: decode from the prefill's caches is right
        tok = np.array([[7 + t]], np.int32)
        tlog, tcache = lm.decode_step(params, cfg, tcache,
                                      {"token": torch.tensor(tok), "pos": 3072 + t})
        jlog, jcache = jlm.decode_step(jparams, jcfg, jcache,
                                       {"token": jnp.asarray(tok), "pos": jnp.asarray(3072 + t)})
        _close(tlog, jlog, LOGITS_ATOL)
