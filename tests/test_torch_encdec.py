"""The port's Whisper encoder-decoder (``repro_torch.arch.encdec``) held
against ``repro.arch.encdec`` on the CPU, in fp32, on JAX's weights
carried across by ``params_from_numpy`` at reduced width: ``layer_norm``,
``gelu_ffn`` and ``sinusoidal_positions``; ``encode``, ``forward``,
``loss_fn`` and ``prefill``; ``decode_step`` from ``init_state(...,
frames=...)`` stepped over S against ``forward`` and against JAX's
steps; and the reference's ``init_decode_state``, which cross-attends a
zero encoder output, pinned in both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import build_arch as jax_build_arch
from repro.arch import encdec as jencdec
from repro.arch.common import sinusoidal_positions as jax_sinusoidal
from repro.config import get_arch_config as jax_arch_config
from repro.nn import layers as jlayers
from repro_torch.arch import build_arch, encdec
from repro_torch.arch.common import params_from_numpy, sinusoidal_positions
from repro_torch.config import get_arch_config
from repro_torch.nn import layers

ATOL = 1e-5  # fp32 layers: the same sums in another order
LOGITS_ATOL = 1e-4  # fp32 logits after two encoder and two decoder layers
NAME = "whisper-medium"


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("seq,dim", [(16, 256), (1500, 1024), (7, 9)])
def test_sinusoidal_positions_match_jax(seq, dim):
    """Within 1e-6 plus pos · 2^-23: the angle pos · inv carries pos times
    the last-place difference of the two packages' fp32 ``exp`` in inv."""
    _close(sinusoidal_positions(seq, dim), jax_sinusoidal(seq, dim), 1e-6 + seq * 2.0 ** -23)


def test_layer_norm_and_gelu_ffn_match_jax():
    x, scale, bias = _x((2, 5, 12), 0, 3.0), _x((12,), 1), _x((12,), 2)
    _close(layers.layer_norm(*map(torch.tensor, (x, scale, bias))),
           jlayers.layer_norm(*map(jnp.asarray, (x, scale, bias))))
    jp = jlayers.init_gelu_ffn(jax.random.PRNGKey(0), 12, 20)
    jp = {**jp, "b_in": jnp.asarray(_x((20,), 3)), "b_out": jnp.asarray(_x((12,), 4))}
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    _close(layers.gelu_ffn(torch.tensor(x), p), jlayers.gelu_ffn(jnp.asarray(x), jp))
    assert set(layers.init_gelu_ffn(torch.Generator(), 12, 20)) == set(jp)


def _pair():
    jcfg, cfg = jax_arch_config(NAME).reduced(), get_arch_config(NAME).reduced()
    jparams = jencdec.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    arrays = {"frames": rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
              "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
              "labels": rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


def test_reduced_whisper_matches_jax():
    jcfg, cfg, jparams, params = _pair()
    jb, tb = _batch(cfg, 2, 12, seed=1)
    _close(encdec.encode(params, cfg, tb["frames"]), jencdec.encode(jparams, jcfg, jb["frames"]))
    logits, aux = encdec.forward(params, cfg, tb)
    jlogits, jaux = jencdec.forward(jparams, jcfg, jb)
    assert logits.shape == jlogits.shape == (2, 12, params["embed"].shape[0])
    _close(logits, jlogits, LOGITS_ATOL)
    _close(aux, jaux)
    _close(encdec.loss_fn(params, cfg, tb), jencdec.loss_fn(jparams, jcfg, jb), LOGITS_ATOL)
    last, none = encdec.prefill(params, cfg, tb)
    assert none is None
    _close(last, logits[:, -1:], LOGITS_ATOL)


def test_decode_from_frames_stepped_over_s_matches_forward_and_jax():
    """The serving path: ``init_state`` with the frames, then one token a
    step from position 0, gives ``forward``'s logits at every position,
    and JAX's steps, in both packages."""
    jcfg, cfg, jparams, params = _pair()
    jb, tb = _batch(cfg, 2, 6, seed=2)
    logits, _ = encdec.forward(params, cfg, tb)
    state = encdec.init_state(params, cfg, 2, 16, frames=tb["frames"])
    jstate = jencdec.init_state(jparams, jcfg, 2, 16, frames=jb["frames"])
    _close(state["cross"]["k"], jstate["cross"]["k"])
    _close(state["cross"]["v"], jstate["cross"]["v"])
    for t in range(6):
        tok = tb["tokens"][:, t:t + 1]
        step, state = encdec.decode_step(params, cfg, state, {"token": tok, "pos": t})
        jstep, jstate = jencdec.decode_step(jparams, jcfg, jstate,
                                            {"token": jb["tokens"][:, t:t + 1],
                                             "pos": jnp.asarray(t, jnp.int32)})
        _close(step, logits[:, t:t + 1], LOGITS_ATOL)
        _close(step, jstep, LOGITS_ATOL)
    _close(state["self"].k, jstate["self"].k)
    np.testing.assert_array_equal(state["self"].pos.numpy(), np.asarray(jstate["self"].pos))


def test_init_decode_state_cross_attends_zeros_of_the_reference_is_pinned():
    """Pin of a reference oddity (``repro.arch.encdec.init_state`` without
    frames, which ``build_arch``'s ``init_decode_state`` calls): the
    encoder output is zeros, so the cross K is 0 and V its bias, and decode
    ignores the audio.  Both packages do so."""
    jcfg, cfg, jparams, params = _pair()
    # a non-zero V bias, so that the pinned V is more than zeros
    jparams = jax.tree.map(lambda t: t, jparams)
    bv = _x(jparams["dec_layers"]["cross_attn"]["bv"].shape, 5)
    jparams["dec_layers"]["cross_attn"]["bv"] = jnp.asarray(bv)
    params["dec_layers"]["cross_attn"]["bv"] = torch.tensor(bv)
    state = build_arch(cfg).init_decode_state(params, 1, 8)
    jstate = jax_build_arch(jcfg).init_decode_state(jparams, 1, 8)
    h, hd = cfg.num_heads, cfg.head_dim
    assert not state["cross"]["k"].any() and not np.asarray(jstate["cross"]["k"]).any()
    want_v = np.broadcast_to(bv.reshape(cfg.num_layers, 1, 1, h, hd),
                             (cfg.num_layers, 1, cfg.encoder_seq, h, hd))
    _close(state["cross"]["v"], want_v, 0)
    _close(jstate["cross"]["v"], want_v, 0)
    jb, tb = _batch(cfg, 1, 4, seed=3)
    step, _ = encdec.decode_step(params, cfg, state, {"token": tb["tokens"][:, :1], "pos": 0})
    jstep, _ = jencdec.decode_step(jparams, jcfg, jstate,
                                   {"token": jb["tokens"][:, :1], "pos": jnp.asarray(0, jnp.int32)})
    _close(step, jstep, LOGITS_ATOL)
    heard, _ = encdec.decode_step(params, cfg,
                                  encdec.init_state(params, cfg, 1, 8, frames=tb["frames"]),
                                  {"token": tb["tokens"][:, :1], "pos": 0})
    assert float((step - heard).abs().max()) > 1e-2


def test_init_params_and_input_specs_match_jax():
    cfg = dataclasses.replace(get_arch_config(NAME).reduced(), dtype="bfloat16")
    jtree = jax.eval_shape(lambda k: jencdec.init_params(k, cfg), jax.random.PRNGKey(0))
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg)
    want = {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
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
    assert bool((params["dec_layers"]["ln1"]["scale"] == 1).all())
    spec = build_arch(cfg).input_specs("prefill_32k", override_batch=2)
    jspec = jax_build_arch(jax_arch_config(NAME).reduced()).input_specs("prefill_32k",
                                                                       override_batch=2)
    assert {k: tuple(v.shape) for k, v in spec.items()} == {k: v.shape for k, v in jspec.items()}
    assert spec["frames"].dtype == torch.bfloat16
