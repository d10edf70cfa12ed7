"""The port's attention held against the JAX package on the CPU: the
``swa_attention`` twin against JAX's oracle and its Pallas kernel (in
interpret mode, as ``tests/test_kernels.py`` runs it) at hd 64, 128, 256
and 96 and at the band builds' hd 2,304 and 4,096, a plain mirror of the
band builds' two passes (hd 512 to 4,096), their workspace's band width
and group planner, the builds the wrapper routes to and exports, the
kernel wrapper's head-dim padding (to 512 and beyond too),
the three branches of ``gqa_attention`` with a spy on the branch taken
(the banded one also at hd 256 and 512), one bf16 case,
decode attention over the KV cache, and ``swa_bf16_bound`` against an
emulation of the bf16 kernel's arithmetic.  Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import swa_attention as jax_swa_pallas
from repro.kernels.ref import swa_attention_ref as jax_swa_ref
from repro.nn import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as swa_kernel
from repro_torch.nn import attention as tattn

ATOL = 1e-5  # fp32: the same function, sums in another order (measured <= 1.2e-6)


def _qkv(b, s, h, kh, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


def _repeat(a, rep):
    return np.repeat(a, rep, axis=2)


@pytest.mark.parametrize("s", [128, 256, 1024])
@pytest.mark.parametrize("window", [64, 128, 300, 1024])
@pytest.mark.parametrize("hd", [64, 128, 256, 96])
def test_swa_plain_matches_jax_kernel_and_oracle(s, window, hd):
    q, k, v = _qkv(2, s, 2, 2, hd, seed=s + window + hd)
    got = ref.swa_attention_plain(*_torch(q, k, v), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_swa_ref(*_jax(q, k, v), window=window)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_swa_pallas(*_jax(q, k, v), window=window)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,kh", [(4, 2), (12, 1)])
def test_swa_plain_reads_kv_heads_in_place(h, kh):
    """Query head i uses KV head i // (H/K): the twin on (B, S, K, hd)
    equals JAX's oracle on the KV repeated to H heads."""
    q, k, v = _qkv(1, 256, h, kh, 64, seed=h)
    got = ref.swa_attention_plain(*_torch(q, k, v), window=100).numpy()
    want = jax_swa_ref(*_jax(q, _repeat(k, h // kh), _repeat(v, h // kh)), window=100)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_ops_routes_cpu_to_the_twin_and_counts_no_launch():
    q, k, v = _torch(*_qkv(1, 128, 2, 1, 64, seed=0))
    before = swa_kernel.LAUNCHES
    assert torch.equal(ops.swa_attention(q, k, v, window=64),
                       ref.swa_attention_plain(q, k, v, window=64))
    assert swa_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.swa_attention(q.to("meta"), k.to("meta"), v.to("meta"), window=64)


def _branch_case(s, window, branch, heads=(4, 2, 64), tag=""):
    return pytest.param(s, window, branch, heads, id=f"{s}-{window}-{branch}{tag}")


@pytest.mark.parametrize("s,window,branch,heads", [
    _branch_case(256, 0, "plain"), _branch_case(256, 64, "plain"),
    _branch_case(2048, 1024, "plain"), _branch_case(3072, 0, "flash"),
    _branch_case(3072, 2048, "flash"), _branch_case(3072, 1024, "banded"),
    # RecurrentGemma-9B's local attention: one KV head of hd 256, window 2048
    _branch_case(4096, 2048, "banded", heads=(2, 1, 256), tag="-hd256"),
    # hd 512, the band builds' narrowest routed hd
    _branch_case(3072, 1024, "banded", heads=(2, 1, 512), tag="-hd512")])
def test_gqa_attention_branches_match_jax(s, window, branch, heads):
    h, kh, hd = heads
    q, k, v = _qkv(1, s, h, kh, hd, seed=s + window)
    before = dict(tattn.BRANCHES)
    got = tattn.gqa_attention(*_torch(q, k, v), causal=True, window=window)
    taken = [name for name in before if tattn.BRANCHES[name] != before[name]]
    assert taken == [branch]
    want = jattn.gqa_attention(*_jax(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hd,width", [(1, 64), (64, 64), (65, 128), (200, 256), (256, 256),
                                      (257, 512), (288, 512), (512, 512), (513, 768)])
def test_padded_head_dim_rule(hd, width):
    """The builds up to 256, then the next multiple of 256 (the chunk)."""
    assert swa_kernel.padded_head_dim(hd) == width


@pytest.mark.parametrize("hd,fp32,bf16", [
    (64, "scalar-fp32-hd64", "wgmma-bf16-hd64"), (96, "scalar-fp32-hd128", "wgmma-bf16-hd128"),
    (256, "scalar-fp32-hd256", "wgmma-bf16-hd256"),
    (288, "band-scalar-fp32", "band-wgmma-bf16"),
    (768, "band-scalar-fp32", "band-wgmma-bf16"),
    (2048, "band-scalar-fp32", "band-wgmma-bf16"),
    (2049, "band-scalar-fp32", "band-wgmma-bf16"), (4096, "band-scalar-fp32", "band-wgmma-bf16"),
    (256 * 65535 - 100, "band-scalar-fp32", "band-wgmma-bf16")])
def test_build_of_routes_by_dtype_and_head_dim(hd, fp32, bf16):
    """The build a launch runs, by dtype and padded hd, with no launch:
    the one-block builds up to hd 256, the band builds (two passes
    through a score workspace) from hd 512 (288 padded to it) up to the
    widest hd the wrapper takes; never the chunked build they replaced."""
    width = swa_kernel.padded_head_dim(hd)
    assert swa_kernel.build_of(torch.float32, width) == fp32
    assert swa_kernel.build_of(torch.bfloat16, width) == bf16
    for dtype in (torch.float32, torch.bfloat16):
        assert swa_kernel.split_of(dtype, width) != swa_kernel.CHUNKS


@pytest.mark.parametrize("dtype,tag", [(torch.float32, "fp32"), (torch.bfloat16, "bf16")])
def test_build_of_reaches_every_exported_build(dtype, tag):
    """Over every hd from 1 to 4,096 (padded as the wrapper pads it), the
    builds a launch can run are exactly the dtype's share of
    ``BUILDS``: a routing change cannot leave a build unreached, or
    reach one the wrapper does not export."""
    image = {swa_kernel.build_of(dtype, swa_kernel.padded_head_dim(hd)) for hd in range(1, 4097)}
    assert image == {name for name in swa_kernel.BUILDS if tag in name}


@pytest.mark.parametrize("s", [128, 192])
@pytest.mark.parametrize("window", [1, 64, 100])
@pytest.mark.parametrize("hd", [2304, 4096])
def test_swa_plain_matches_jax_above_hd_2048(s, window, hd):
    """The twin at the band builds' head dims against JAX's oracle, and
    against its Pallas kernel (interpret mode) where it takes S (a
    multiple of 128)."""
    q, k, v = _qkv(1, s, 2, 2, hd, seed=s + window + hd)
    got = ref.swa_attention_plain(*_torch(q, k, v), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_swa_ref(*_jax(q, k, v), window=window)),
                               rtol=0, atol=ATOL)
    if s % 128 == 0:
        np.testing.assert_allclose(
            got, np.asarray(jax_swa_pallas(*_jax(q, k, v), window=window)), rtol=0, atol=ATOL)


def _band_two_pass(q, k, v, *, window, block_keys):
    """A plain mirror of the band builds' two passes (fp32): for each
    128-row q tile of each head, its band's keys from the first 64-key
    tile a row reaches to the diagonal; pass 1 takes the scaled scores a
    block of ``block_keys`` keys at a time over the whole head dim, masks
    them with -1e30, and keeps each row's max and sum of exp a block;
    the statistics are merged in ascending block order (the maxima, then
    the sums rescaled to their max); pass 2 takes p = exp(s - m) over the
    band and O = P V / l in slices of 256 columns."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    out = torch.empty(b, s, h, hd)
    for bi in range(b):
        for hi in range(h):
            g = hi // rep
            for q0 in range(0, s, swa_kernel.BAND_ROWS):
                q1 = min(q0 + swa_kernel.BAND_ROWS, s)
                k_start = max(q0 - window + 1, 0) // swa_kernel.BAND_TILE * swa_kernel.BAND_TILE
                qp = torch.arange(q0, q1)[:, None]
                blocks, maxes, sums = [], [], []
                for k0 in range(k_start, q1, block_keys):
                    k1 = min(k0 + block_keys, s)
                    sc = q[bi, q0:q1, hi] @ k[bi, k0:k1, g].T * hd ** -0.5
                    kp = torch.arange(k0, k1)[None, :]
                    sc = torch.where((kp <= qp) & (kp > qp - window), sc, torch.tensor(-1e30))
                    blocks.append(sc)
                    maxes.append(sc.amax(-1))
                    sums.append(torch.exp(sc - maxes[-1][:, None]).sum(-1))
                m = torch.stack(maxes).amax(0)
                total = torch.zeros_like(m)
                for mt, lt in zip(maxes, sums):  # ascending block order
                    total = total + lt * torch.exp(mt - m)
                p = torch.exp(torch.cat(blocks, dim=1) - m[:, None])
                vb = v[bi, k_start:k_start + p.shape[1], g]
                for c0 in range(0, hd, swa_kernel.CHUNK):
                    out[bi, q0:q1, hi, c0:c0 + swa_kernel.CHUNK] = (
                        p @ vb[:, c0:c0 + swa_kernel.CHUNK] / total.clamp_min(1e-30)[:, None])
    return out


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (1, 128, 4, 2, 2304, 64), (2, 192, 2, 1, 2304, 100), (1, 320, 4, 1, 4096, 1),
    (1, 256, 2, 1, 2560, 300), (1, 256, 4, 2, 512, 100)])
def test_band_two_pass_mirror_matches_jax(b, s, h, kh, hd, window):
    """The band builds' decomposition (per-block scores and statistics,
    the merge in block order, P V in 256-column slices), in both block
    widths (bf16's 256 keys, fp32's 128), with K < H, against JAX's
    oracle on the KV repeated to H heads, and its Pallas kernel where it
    takes S.  The band reaches past S's start (window 300), is one tile
    (window 1), and S % 128 == 64 leaves a half q tile; hd 512, two
    slices of 256 columns, is the band's narrowest routed hd."""
    q, k, v = _qkv(b, s, h, kh, hd, seed=s + hd + window)
    want = np.asarray(jax_swa_ref(*_jax(q, _repeat(k, h // kh), _repeat(v, h // kh)),
                                  window=window))
    for dtype, block in swa_kernel.BAND_KEYS.items():
        got = _band_two_pass(*_torch(q, k, v), window=window, block_keys=block).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=str(dtype))
    if s % 128 == 0:
        pallas = jax_swa_pallas(*_jax(q, _repeat(k, h // kh), _repeat(v, h // kh)), window=window)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [64, 192, 1024, 8192])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 100, 2048, 10_000])
def test_band_blocks_hold_every_q_tiles_band(s, window):
    """``band_blocks`` gives each 128-row q tile's slab row room for its
    whole band, from the first 64-key tile its first row reaches to its
    last row (or S), in pass-1 blocks of either width, and no block more
    than the widest band needs."""
    for dtype, width in swa_kernel.BAND_KEYS.items():
        blocks = swa_kernel.band_blocks(s, window, dtype)
        need = max(-(-(min(q0 + 128, s) - max(q0 - window + 1, 0) // 64 * 64) // width)
                   for q0 in range(0, s, 128))
        assert need <= blocks
        assert blocks * width - width < 64 * min(2 + -(-(window - 1) // 64), -(-s // 64))
    assert swa_kernel.band_blocks(8192, 2048, torch.bfloat16) == 9
    assert swa_kernel.band_blocks(8192, 2048, torch.float32) == 17


@pytest.mark.parametrize("heads,s,item_bytes,cap", [
    (16, 8192, 1_188_864, None), (16, 8192, 1_188_864, 10 * 1_188_864),
    (16, 8192, 1_188_864, 70 * 1_188_864), (3, 320, 1000, 2500), (3, 320, 1000, 6500),
    (5, 64, 7, 1), (65535, 128, 1, 1 << 40)])
def test_plan_band_groups_cover_every_item_under_the_cap(heads, s, item_bytes, cap):
    """The groups of a band call cover every (b * H + h, q tile) item once,
    in order; each stays within the cap (one item at least, when one
    alone is over it) and within the grid's 65,535 items; a group holds
    whole heads whenever the cap holds one."""
    groups = swa_kernel.plan_band_groups(heads, s, item_bytes, cap)
    limit = swa_kernel.WORKSPACE_CAP if cap is None else cap
    per_head = -(-s // 128)
    assert [first for first, _ in groups] == list(
        np.cumsum([0] + [n for _, n in groups[:-1]]))
    assert sum(n for _, n in groups) == heads * per_head
    for first, n in groups:
        assert 1 <= n <= swa_kernel.MAX_GROUP_ITEMS
        assert n * item_bytes <= limit or n == 1
        if limit // item_bytes >= per_head:
            assert first % per_head == 0 and n % per_head == 0 or first + n == heads * per_head
    if cap is None:  # RecurrentGemma-9B's local attention at a wide hd: one group
        assert groups == [(0, heads * per_head)]


@pytest.mark.parametrize("hd", [1, 48, 96, 160, 200, 256, 288, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_head_dim_matches_the_unpadded_twin(hd, dtype):
    """The kernel wrapper's hd padding, run through the twin: q, k, v
    zero-padded to 64, 128, 256 or a multiple of 256, the original hd's
    scale, the output sliced back, against the twin at the unpadded hd
    within 1e-6 up to hd 256 (bf16:
    the same fp32 values up to their summation order, then rounded to
    bf16 once, so at most one bf16 step, 2^-7 relative, apart).  Above
    256 the CPU's matmul sums a score's hd products in another order at
    the padded width than at hd (the zero columns themselves add exact
    zeros): there the file's ATOL for sums in another order holds
    (measured <= 2.3e-6 at hd 288 to 384)."""
    q, k, v = _torch(*_qkv(2, 256, 4, 2, hd, seed=hd), dtype=dtype)
    got = swa_kernel.with_padded_head_dim(ref.swa_attention_plain, q, k, v, window=100)
    want = ref.swa_attention_plain(q, k, v, window=100)
    assert got.shape == want.shape and got.dtype == dtype
    bf16 = dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2.0 ** -7 if bf16 else 0,
                               atol=1e-6 if hd <= swa_kernel.CHUNK else ATOL)


def test_banded_reference_matches_jax():
    q, k, v = _qkv(1, 512, 2, 1, 64, seed=11)
    got = tattn.banded_flash_attention(*_torch(q, k, v), window=128, block=128)
    want = jattn.banded_flash_attention(*_jax(q, k, v), window=128, block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bf16_banded_branch_against_jax():
    """bf16 at the banded branch (S=3072, w=1024).  JAX's banded path
    rounds the scores and the probabilities to bf16 (plain_attention);
    the port's branch (the kernel, here its twin) keeps them in fp32 and
    rounds only its output.  bf16 keeps 8 significant bits (relative
    rounding 2**-9 = 2e-3): a score of |s| <= ~5 moves by <= 1e-2, a
    probability by ~1%, and the output (|o| <= ~2, itself rounded twice)
    by a few bf16 steps of 2**-8 near 1 -- 1.6e-2 measured; JAX's own
    bf16 tolerance for this kernel, 5e-2 (tests/test_kernels.py), holds
    it."""
    q, k, v = _qkv(1, 3072, 4, 2, 64, seed=5)
    got = tattn.gqa_attention(*_torch(q, k, v, dtype=torch.bfloat16), window=1024)
    want = jattn.gqa_attention(*_jax(q, k, v, dtype=jnp.bfloat16), window=1024)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=5e-2)


@pytest.mark.parametrize("cap,steps,window", [(16, 5, 0), (8, 13, 8)])
def test_kvcache_and_decode_attention_match_jax(cap, steps, window):
    rng = np.random.default_rng(cap + steps)
    tcache = tattn.KVCache.init(2, cap, 2, 64, torch.float32)
    jcache = jattn.KVCache.init(2, cap, 2, 64, jnp.float32)
    for _ in range(steps):  # past the capacity: the ring wraps
        q, k, v = (rng.normal(size=(2, 1, n, 64)).astype(np.float32) for n in (4, 2, 2))
        tcache = tcache.append(*_torch(k, v))
        jcache = jcache.append(*_jax(k, v))
        got = tattn.decode_attention(_torch(q)[0], tcache, window=window)
        want = jattn.decode_attention(_jax(q)[0], jcache, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))
    assert int(tcache.pos) == int(jcache.pos) == steps


def _bf16_kernel_numerics(q, k, v, *, window, tile=128, drop_tile=None):
    """A plain emulation of the bf16 ``swa_attention`` kernel's arithmetic:
    128-key tiles through an online softmax in fp32, l summed from the
    fp32 p, P rounded to bf16 before the product with v (summed in fp32),
    the output rounded to bf16 once.  Every row visits every tile: a tile
    wholly masked before a row's band is cleared by alpha = 0, one after
    it adds p = 0, so the result is the kernel's band-only loop.
    ``drop_tile`` skips one key tile, as a wrong kernel would."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, 2).transpose(1, 2)
    pos = torch.arange(s)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    for t in range(s // tile):
        if t == drop_tile:
            continue
        keys = slice(t * tile, (t + 1) * tile)
        sc = qf @ kf[:, :, keys].transpose(-1, -2) * hd ** -0.5
        kp = pos[keys][None, :]
        sc = torch.where((kp <= pos[:, None]) & (kp > pos[:, None] - window), sc,
                         torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, keys]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 512, 4, 1, 64, 300), (1, 768, 2, 2, 128, 256), (1, 1024, 12, 1, 128, 512)])
def test_swa_bf16_bound_holds_the_kernel_numerics(b, s, h, kh, hd, window):
    """The bf16 kernel rounds P to bf16 for its second tensor-core
    product.  Its emulation stays within ``swa_bf16_bound`` of the fp32
    attention, breaks the output-rounding-only bound 2^-8 |o32| + 3e-5
    that the card check used before, and a kernel that skips one key
    tile of the band breaks the new bound too.  ``pytest -s`` prints the
    readings."""
    q, k, v = _torch(*_qkv(b, s, h, kh, hd, seed=s + window), dtype=torch.bfloat16)
    o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=window)
    bound = ref.swa_bf16_bound(q, k, v, window=window)
    old_bound = o32.abs() * 2.0 ** -8 + 3e-5
    err = (_bf16_kernel_numerics(q, k, v, window=window).float() - o32).abs()
    mid = (s - 1) // 128 - window // 256  # a key tile in the middle of the last rows' band
    wrong = (_bf16_kernel_numerics(q, k, v, window=window, drop_tile=mid).float() - o32).abs()
    print(f"swa bf16 emulation {(b, s, h, kh, hd, window)}: max err / swa_bf16_bound "
          f"{float((err / bound).max()):.3f}; / old bound {float((err / old_bound).max()):.1f}, "
          f"{float((err > old_bound).float().mean()):.1%} of outputs over it; one tile dropped: "
          f"{float((wrong / bound).max()):.1f}x the new bound")
    assert bool((err <= bound).all()), float((err / bound).max())
    assert bool((err > old_bound).any())
    assert bool((wrong > bound).any())


def test_swa_bf16_bound_is_the_documented_limit():
    """``2^-8 (|o32| + (P|v|) / l) + 3e-5`` through the twin, and the same
    through the banded path that the card check gives it at long S."""
    q, k, v = _torch(*_qkv(1, 256, 2, 1, 64, seed=9), dtype=torch.bfloat16)
    o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=100)
    pv = ref.swa_attention_plain(q.float(), k.float(), v.float().abs(), window=100)
    bound = ref.swa_bf16_bound(q, k, v, window=100)
    torch.testing.assert_close(bound, (o32.abs() + pv) / 256 + 3e-5, rtol=0, atol=0)
    banded = ref.swa_bf16_bound(
        q, k, v, window=100,
        attention=lambda *qkv, window: tattn.banded_flash_attention(*qkv, window=window, block=128))
    torch.testing.assert_close(banded, bound, rtol=0, atol=1e-7)
