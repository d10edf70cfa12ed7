"""The port's LM zoo (dense, MoE and VLM families) held against the JAX
package on the CPU, on the same weights carried across by
``arch.common.params_from_numpy``: the registry field for field, ``forward``
(the MoE aux losses too), ``loss_fn``, ``prefill`` (logits and caches)
and four ``decode_step``s of every dense/MoE/VLM config at ``reduced()``
width and of the reduced Mistral-Large with a 1024-token window at
S=3072 (the banded branch, so the kernel's twin), every family's
``Arch`` built and prefilling, the input specs, and the ``arch_demo``
CLI on every family.  It also pins a fault of the reference that the
port keeps: decode after prefill is right only when S % window == 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import build_arch as jax_build_arch
from repro.arch.api import SHAPES as JAX_SHAPES
from repro.arch import lm as jlm
from repro.arch.common import cross_entropy as jax_cross_entropy
from repro.config import get_arch_config as jax_arch_config
from repro.config import list_archs as jax_list_archs
from repro_torch.arch import SHAPES, build_arch
from repro_torch.arch import lm
from repro_torch.arch.common import cross_entropy, params_from_numpy
from repro_torch.config import get_arch_config, list_archs
from repro_torch.launch import arch_demo
from repro_torch.nn import attention as tattn

ATOL = 1e-4  # fp32 logits after 2 layers: matmul and softmax sums in another order
LM_CONFIGS = [n for n in jax_list_archs() if jax_arch_config(n).family in ("dense", "moe", "vlm")]


def test_registry_matches_jax_field_for_field():
    assert list_archs() == jax_list_archs()
    for name in jax_list_archs():
        mine, theirs = get_arch_config(name), jax_arch_config(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(theirs.reduced()), name
        assert mine.q_per_kv == theirs.q_per_kv
        assert mine.param_count() == theirs.param_count(), name
        assert mine.active_param_count() == theirs.active_param_count(), name
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch_config("no-such-arch")


def _pair(name, **changes):
    """The (JAX, port) configs of ``name`` at reduced width, JAX's params
    from PRNGKey(0), and the same params as the port's tree on the CPU."""
    jcfg = dataclasses.replace(jax_arch_config(name).reduced(), **changes)
    cfg = dataclasses.replace(get_arch_config(name).reduced(), **changes)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, b, s, seed, labels=False):
    """The same batch for both packages: tokens (and VLM patches) over
    S positions in all."""
    rng = np.random.default_rng(seed)
    tv = cfg.vision_tokens if cfg.family == "vlm" else 0
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - tv)).astype(np.int32)}
    if tv:
        arrays["patches"] = rng.normal(size=(b, tv, lm.VISION_STUB_DIM)).astype(np.float32)
    if labels:
        arrays["labels"] = rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _prefill_and_decode(jcfg, cfg, jparams, params, jb, tb, steps=4):
    """Prefill, then ``steps`` decode steps fed the same tokens, on both
    sides; returns the list of (port, JAX) logits and the last caches."""
    jlog, jcache = jlm.prefill(jparams, jcfg, jb)
    tlog, tcache = lm.prefill(params, cfg, tb)
    pairs = [(tlog, jlog)]
    _close(tcache.k, jcache.k, 1e-5)
    _close(tcache.v, jcache.v, 1e-5)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    s = tb["tokens"].shape[1] + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    rng = np.random.default_rng(s)
    for t in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (tb["tokens"].shape[0], 1)).astype(np.int32)
        jlog, jcache = jlm.decode_step(jparams, jcfg, jcache,
                                       {"token": jnp.asarray(tok), "pos": jnp.asarray(s + t, jnp.int32)})
        tlog, tcache = lm.decode_step(params, cfg, tcache, {"token": torch.tensor(tok), "pos": s + t})
        pairs.append((tlog, jlog))
    return pairs, (tcache, jcache)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_reduced_config_matches_jax(name):
    jcfg, cfg, jparams, params = _pair(name)
    jb, tb = _batch(cfg, 2, 24, seed=1, labels=True)
    tl, aux = lm.forward(params, cfg, tb)
    jl, jaux = jlm.forward(jparams, jcfg, jb)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    _close(tl, jl)
    _close(aux, jaux)
    _close(lm.loss_fn(params, cfg, tb), jlm.loss_fn(jparams, jcfg, jb))
    pairs, (tcache, jcache) = _prefill_and_decode(jcfg, cfg, jparams, params, jb, tb)
    for got, want in pairs:
        assert got.shape == want.shape
        _close(got, want)
    _close(tcache.k, jcache.k, 1e-5)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


def test_banded_prefill_and_decode_match_jax():
    """The reduced Mistral-Large with a 1024-token window at S=3072: every
    layer's prefill attention takes the banded branch (the kernel's place;
    on the CPU its twin)."""
    jcfg, cfg, jparams, params = _pair("mistral-large-123b", sliding_window=1024)
    jb, tb = _batch(cfg, 1, 3072, seed=2, labels=True)
    before = dict(tattn.BRANCHES)
    _close(lm.forward(params, cfg, tb)[0], jlm.forward(jparams, jcfg, jb)[0])
    pairs, (tcache, _) = _prefill_and_decode(jcfg, cfg, jparams, params, jb, tb)
    for got, want in pairs:
        _close(got, want)
    taken = {k: tattn.BRANCHES[k] - before[k] for k in before}
    # forward (no param requires grad) + prefill
    assert taken == {"plain": 0, "flash": 0, "banded": 2 * cfg.num_layers, "banded_grad": 0}
    assert tcache.k.shape == (cfg.num_layers, 1, 1024, cfg.num_kv_heads, cfg.head_dim)


def test_cross_entropy_matches_jax_and_skips_negative_labels():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    labels = np.array([[0, 3, -1, 6, 2], [-1, -1, 1, 1, 5]], np.int32)
    _close(cross_entropy(torch.tensor(logits), torch.tensor(labels)),
           jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)


@pytest.mark.parametrize("s,window,right", [
    (128, 64, True), (192, 64, True), (96, 64, False), (32, 64, False), (32, 0, False)])
def test_prefill_then_decode_fault_of_the_reference_is_pinned(s, window, right):
    """Pin of a reference fault (``repro.arch.lm.prefill`` with
    ``nn.attention.KVCache.append``): prefill keeps the last
    cap = min(S, window) positions (S for full attention) in plain order,
    and the first decode writes slot S % cap.  Decode after prefill
    equals ``forward`` at position S only for a window with
    S % window == 0; it overwrites a live slot otherwise.  The port
    keeps the reference's semantics, so both packages agree with each
    other in every case.  The fix (a ring layout at prefill and a
    capacity beyond S) is ROADMAP Queue 3's."""
    name = "mistral-large-123b" if window else "yi-6b"
    jcfg, cfg, jparams, params = _pair(name, sliding_window=window)
    jb, tb = _batch(cfg, 1, s + 1, seed=s)
    prompt_j = {"tokens": jb["tokens"][:, :s]}
    prompt_t = {"tokens": tb["tokens"][:, :s]}
    nxt = {"token": tb["tokens"][:, s:], "pos": s}
    _, tcache = lm.prefill(params, cfg, prompt_t)
    _, jcache = jlm.prefill(jparams, jcfg, prompt_j)
    tdec, _ = lm.decode_step(params, cfg, tcache, nxt)
    jdec, _ = jlm.decode_step(jparams, jcfg, jcache,
                              {"token": jb["tokens"][:, s:], "pos": jnp.asarray(s, jnp.int32)})
    _close(tdec, jdec)  # the two packages agree, fault and all
    tfwd = lm.forward(params, cfg, tb)[0][:, s:]
    jfwd = jlm.forward(jparams, jcfg, jb)[0][:, s:]
    gap = float((tdec - tfwd).abs().max())
    jgap = float(jnp.abs(jdec - jfwd).max())
    if right:
        assert gap < ATOL and jgap < ATOL
    else:
        assert gap > 1e-2 and jgap > 1e-2  # measured 0.35 to 1.28


@pytest.mark.parametrize("name", ["mixtral-8x22b", "granite-moe-1b-a400m", "mamba2-370m",
                                  "whisper-medium"])
def test_every_family_builds_its_arch_and_prefills(name):
    """The four configs that once raised: each builds its ``Arch`` at full
    size with JAX's ``supports_long``, and at reduced width prefills and
    takes a decode step from ``init_decode_state`` (held against JAX in
    ``tests/test_torch_moe.py``, ``test_torch_ssm.py`` and
    ``test_torch_encdec.py``, and above for the MoE configs)."""
    cfg = get_arch_config(name)
    arch = build_arch(cfg)
    assert arch.cfg is cfg
    assert arch.supports_long == jax_build_arch(jax_arch_config(name)).supports_long
    small = build_arch(cfg.reduced())
    params = small.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((1, 16), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, small.cfg.encoder_seq, small.cfg.d_model))
    logits, _ = small.prefill_fn(params, batch)
    vp = params["embed"].shape[0]
    assert logits.shape == (1, 1, vp) and bool(torch.isfinite(logits).all())
    state = small.init_decode_state(params, 1, 8)
    step, _ = small.decode_fn(params, state, {"token": batch["tokens"][:, :1], "pos": 0})
    assert step.shape == (1, 1, vp) and bool(torch.isfinite(step).all())


def test_hybrid_family_builds_its_arch():
    """RecurrentGemma-9B, once among the families above, builds the
    hybrid ``Arch`` (``arch/hybrid_lm.py``; held against JAX in
    ``tests/test_torch_hybrid.py``)."""
    from repro_torch.arch import hybrid_lm

    cfg = get_arch_config("recurrentgemma-9b")
    arch = build_arch(cfg)
    assert arch.cfg is cfg and arch.supports_long
    small = build_arch(cfg.reduced())
    params = small.init_params(torch.Generator().manual_seed(0))
    state = small.init_decode_state(params, 1, 16)
    assert set(state) == {"rec0", "rec1", "kv2"} and state["kv2"].k.shape[2] == 16
    logits, none = small.prefill_fn(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    assert none is None and logits.shape == (1, 1, params["lm_head"].shape[1])
    assert hybrid_lm.num_super_blocks(cfg) == 13


def test_unknown_family_raises_keyerror_like_jax():
    with pytest.raises(KeyError, match="unknown family"):
        build_arch(get_arch_config("glucose-lstm"))


def test_init_params_shapes_and_dtype():
    cfg = dataclasses.replace(get_arch_config("llava-next-mistral-7b").reduced(), dtype="bfloat16")
    jtree = jax.eval_shape(lambda k: jlm.init_params(k, cfg), jax.random.PRNGKey(0))
    params = build_arch(cfg).init_params(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat = {jax.tree_util.keystr(path): leaf.shape for path, leaf in jleaves}
    mine = {}
    for key, val in params.items():
        for sub, t in (val.items() if isinstance(val, dict) else [(None, val)]):
            assert t.dtype == torch.bfloat16
            mine[f"['{key}']" + (f"['{sub}']" if sub else "")] = tuple(t.shape)
    assert mine == flat
    assert float(params["layers"]["wq"].float().std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    assert not params["layers"]["ln1_scale"].any()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ["yi-6b", "llava-next-mistral-7b", "whisper-medium"])
def test_input_specs_match_jax(shape, name):
    cfg = get_arch_config(name)
    mine = build_arch(cfg).input_specs(shape, override_batch=2)
    theirs = jax_build_arch(jax_arch_config(name)).input_specs(shape, override_batch=2)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in theirs.items()}
    assert all(v.device.type == "meta" for v in mine.values())
    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(JAX_SHAPES[shape])


def test_arch_demo_cli_runs_on_the_cpu(capsys):
    assert arch_demo.main(["--device", "cpu", "--arch", "mistral-large-123b",
                           "--batch", "1", "--prompt-len", "4", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=mistral-large-123b-smoke family=dense L=2 d=256" in out
    assert "decoded 3 tokens" in out and "sampled token ids: [[" in out
    for name in ("mixtral-8x22b", "granite-moe-1b-a400m", "mamba2-370m", "whisper-medium"):
        assert arch_demo.main(["--device", "cpu", "--arch", name, "--batch", "1",
                               "--prompt-len", "2", "--tokens", "2"]) == 0
        assert f"arch={name}-smoke family={get_arch_config(name).family}" in capsys.readouterr().out
    assert arch_demo.main(["--device", "cpu", "--arch", "glucose-lstm"]) == 2
