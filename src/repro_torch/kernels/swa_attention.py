"""Wrapper of the hand-written CUDA kernel ``swa_attention``
(``csrc/swa_attention.cu``), the port of the Pallas kernel
``repro.kernels.swa_attention.swa_attention_pallas``: causal
sliding-window attention over the diagonal band (an online softmax up
to hd 256; above, an exact one from a score workspace).

Unlike the Pallas kernel, which takes the KV heads repeated to H, the
kernel reads k and v as ``(B, S, K, hd)`` with ``H % K == 0`` and
serves query head h from KV head ``h // (H // K)``; K = H is the Pallas
case.  S must be a multiple of 64 (the fp32 kernel's key tile, half the
bf16 kernel's 128-row tile), as ``repro.kernels.ops`` refuses
S % 128 != 0 (the banded branch of ``gqa_attention``, the only caller,
takes S % 1024 == 0).  The kernel is built for hd 64, 128 and 256, and
runs any multiple of 256 above that; any other hd is zero-padded to the
next of these (:func:`with_padded_head_dim`), which is exact.  Only what
the grid cannot hold is refused: more than :data:`MAX_CHUNKS` slices of
256 columns.  bf16 runs on the tensor cores (``wgmma`` + TMA; 64-key
tiles from hd 256) with P rounded to bf16 (``ref.swa_bf16_bound``
states what that costs); fp32 on scalar fp32 FMAs (TF32 would break
fp32's 3e-5), at hd 64, 128 and 256 with Q, K and V staged by TMA so
that the copies overlap the products.

Which build runs a (dtype, padded hd), as :func:`build_of` names it;
:func:`split_of` decides it, and the C entry launches the build it is
told to, so a launch counted under a name ran that build:

* hd 64, 128, 256: ``wgmma-bf16-hd{hd}`` and ``scalar-fp32-hd{hd}``,
  one block a q tile of one query head (the fp32 build's tile is 128
  rows at hd 128, 64 elsewhere).  The fp32 build
  (``swa_attention_kernel_bulk``) stages Q, K and V by TMA on mbarriers,
  one stage each at hd 256 and two at hd 64 and 128, K and V released
  apart (the last warp to release a stage issues its next copy), and
  sums Q K^T and P V in 8 x 8 register tiles, 8 x 4 at hd 64 (Q K^T's
  split over the head dim across lanes, the partial sums added by
  shuffles).
* every hd = 256 c with c >= 2 (hd 512 and up): ``band-wgmma-bf16``
  and ``band-scalar-fp32``, two passes through a banded score
  workspace.  Pass 1 takes Q K^T once over the head dim, one block a
  (128-row q tile, key block of its band, head), the head dim the
  reduction loop (bf16: ``wgmma`` m64n256k16 on TMA-streamed
  64-column boxes, 256-key blocks; fp32: 32-column boxes staged by TMA,
  8 x 8 register tiles, 128-key blocks), and writes the scaled, masked
  scores as fp32 into the workspace, a (q tile, band) slab an item,
  with each row's max and sum of exp a block beside it.  Pass 2, one
  block a (q tile, 256 columns of O, head), the slices of a q tile back
  to back, merges the statistics in ascending block order and walks the
  band: p = exp(s - m) (bf16: rounded to bf16), O += P V, O / l; the
  softmax is exact, with no rescale.  The wrapper allocates the
  workspace and runs the items (b * H + h, q tile) in groups that keep
  it under :data:`WORKSPACE_CAP` (:func:`plan_band_groups`), one launch
  of both passes a group, counted once a call.  The chunked scalar
  build it replaced (each of hd / 256 chunks recomputing the scores
  over the whole head dim) stays in the C entry for comparison; the
  wrapper never sends it.  This is a dispatch by shape, not a fallback:
  a failed build or launch raises.

Where the band starts was measured on an H100 at RecurrentGemma-9B's
local-attention shape with hd widened (``tools/swa_band_boundary.py``;
PERF.md): a (dtype, hd) above 256 goes to the band unless its median is
more than 3% slower than the build it would replace, and hd 256 only if
the band is more than 3% faster than the one-block build.  From hd 512
to 2,048 the band beat the thread-block cluster builds that ran there
before in both dtypes (fp32 0.45-0.73 of their time, bf16 0.13-0.97),
so those builds are gone; at fp32 hd 256 it was 2.8-3.1% slower than
the one-block build, which stays.

Its plain twin is ``repro_torch.kernels.ref.swa_attention_plain``;
the CUDA-or-CPU dispatch is ``repro_torch.kernels.ops.swa_attention``.

:data:`LAUNCHES` counts the kernel's launches in this process, so a run
can show that its path went through the kernel, and
:data:`BUILD_LAUNCHES` the same by build (:func:`build_of`), so it can
show which build ran.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, refuse_autograd

LAUNCHES = 0
BUILD_LAUNCHES: dict[str, int] = {}

HEAD_DIMS = (64, 128, 256)  # the kernel's builds; other hd <= 256 are padded
CHUNK = HEAD_DIMS[-1]  # above it, hd runs in slices of these columns (padded to a multiple)
# how a launch splits hd: the C entry's `split` (BAND is its own C entry)
ONE_BLOCK, CHUNKS, BAND = 0, 1, 2
TILE = 64  # S must be a multiple of this
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEADS = 65535  # B * H blocks along gridDim.y
MAX_CHUNKS = 65535  # hd / CHUNK slices of the head dim (the band build's gridDim.x)
BAND_ROWS = 128  # query rows of a band item (a q tile of one head)
BAND_TILE = 64  # keys of a band tile: the band's alignment
BAND_KEYS = {torch.bfloat16: 256, torch.float32: 128}  # keys of a pass-1 block
WORKSPACE_CAP = 2 << 30  # bytes of the band builds' workspace (scores and statistics)
MAX_GROUP_ITEMS = 65535  # band items of a group, along gridDim.y

_launch_fn = None
_band_fn = None


def _fn():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("swa_attention").swa_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _band():
    global _band_fn
    if _band_fn is None:
        fn = _build.load("swa_attention").swa_attention_band_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _band_fn = fn
    return _band_fn


def _check(q, k, v, window) -> tuple[int, int, int, int, int]:
    named = {"q": q, "k": k, "v": v}
    refuse_autograd("swa_attention", named)
    if q.dtype not in DTYPES:
        raise TypeError(f"swa_attention: q is {q.dtype}, the kernel takes float32 or bfloat16")
    check_operands("swa_attention", named, dict.fromkeys(named, q.dtype))
    for name, t in named.items():  # TMA (bf16) and float4 loads (fp32) read 16-byte units
        if t.data_ptr() % 16:
            raise ValueError(f"swa_attention: {name} does not start on a 16-byte boundary")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"swa_attention: need q (B, S, H, hd) and k, v (B, S, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != hd or kh < 1 or h % kh:
        raise ValueError(f"swa_attention: k, v must be (B, S, K, hd) with H % K == 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 1 <= hd <= CHUNK * MAX_CHUNKS:
        raise ValueError(f"swa_attention: hd must be 1 to {CHUNK * MAX_CHUNKS} "
                         f"({MAX_CHUNKS} slices of {CHUNK}), got {hd}")
    if min(b, s, h) < 1 or b * h > MAX_HEADS:
        raise ValueError(f"swa_attention: need B, S, H >= 1 and B * H <= {MAX_HEADS}, "
                         f"got B={b} S={s} H={h}")
    if s % TILE:
        raise ValueError(f"swa_attention: S must be a multiple of {TILE}, got {s}")
    if window < 1:
        raise ValueError(f"swa_attention: window must be >= 1, got {window}")
    return b, s, h, kh, hd


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel runs hd at: the least of :data:`HEAD_DIMS`
    that holds it, above that the next multiple of :data:`CHUNK`."""
    return next((p for p in HEAD_DIMS if p >= hd), -(-hd // CHUNK) * CHUNK)


def split_of(dtype: torch.dtype, hd: int) -> int:
    """How a launch of ``dtype`` at the padded head dim ``hd`` splits it,
    the one place this is decided, by the measurement in the module note
    (taken per dtype; its boundary fell at the same hd in both):
    :data:`ONE_BLOCK` at :data:`HEAD_DIMS`, :data:`BAND` (the two passes
    through the score workspace) above.  :data:`CHUNKS`, the chunked
    build the band replaced, is never chosen."""
    return ONE_BLOCK if hd in HEAD_DIMS else BAND


def build_of(dtype: torch.dtype, hd: int) -> str:
    """The name of the build of ``csrc/swa_attention.cu`` that a launch
    at the padded head dim ``hd`` runs, one of :data:`BUILDS` (the module
    note lists them): bf16 on ``wgmma``, fp32 on the scalar kernel, split
    as :func:`split_of` says (``band-...`` for the two passes)."""
    kind = "wgmma" if dtype == torch.bfloat16 else "scalar"
    dt = "bf16" if dtype == torch.bfloat16 else "fp32"
    if split_of(dtype, hd) == ONE_BLOCK:
        return f"{kind}-{dt}-hd{hd}"
    return f"band-{kind}-{dt}"


# every name build_of gives: the one-block builds and the band builds
BUILDS = (*(f"{kind}-hd{hd}" for kind in ("scalar-fp32", "wgmma-bf16") for hd in HEAD_DIMS),
          "band-scalar-fp32", "band-wgmma-bf16")


def band_blocks(s: int, window: int, dtype: torch.dtype) -> int:
    """Key blocks of a band item's slab row: enough for the widest band a
    128-row q tile has, ``2 + ceil((window - 1) / 64)`` tiles of 64 keys
    (at most ``ceil(S / 64)``), in pass-1 blocks of :data:`BAND_KEYS`."""
    tiles = min(2 + -(-(window - 1) // BAND_TILE), -(-s // BAND_TILE))
    return -(-tiles * BAND_TILE // BAND_KEYS[dtype])


def band_item_bytes(s: int, window: int, dtype: torch.dtype) -> int:
    """Workspace bytes of one band item: its fp32 score slab (128 rows x
    the blocks' keys) and each row's (max, sum) a block."""
    blocks = band_blocks(s, window, dtype)
    return BAND_ROWS * blocks * (BAND_KEYS[dtype] * 4 + 8)


def plan_band_groups(heads: int, s: int, item_bytes: int,
                     cap: int | None = None) -> list[tuple[int, int]]:
    """The groups a band call runs, as (first item, items): the items
    ``(b * H + h) * ceil(S / 128) + q tile`` of ``heads = B * H`` heads in
    order, each group's workspace (``items * item_bytes``) within ``cap``
    (:data:`WORKSPACE_CAP` unless given) and at most
    :data:`MAX_GROUP_ITEMS` items.  A group holds whole heads when the cap
    holds one head's items, else as many items as fit (at least one),
    which may start and end inside a head."""
    cap = WORKSPACE_CAP if cap is None else cap
    per_head = -(-s // BAND_ROWS)
    total = heads * per_head
    fit = max(1, min(cap // item_bytes, MAX_GROUP_ITEMS))
    if fit >= per_head:
        fit -= fit % per_head
    return [(first, min(fit, total - first)) for first in range(0, total, fit)]


def with_padded_head_dim(attention, q, k, v, *, window: int) -> torch.Tensor:
    """``attention(q, k, v, window=, scale=)`` at :func:`padded_head_dim`:
    q, k and v zero-padded on their last dim, the scale ``hd ** -0.5`` of
    the original hd, the output sliced back to hd.  Exact: the zero
    columns add exact zeros to q k^T, and v's zero columns give output
    columns that are sliced away.  At an hd the kernel runs as it is,
    nothing is copied."""
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    if width == hd:
        return attention(q, k, v, window=window, scale=hd ** -0.5)
    pad = [torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v)]
    return attention(*pad, window=window, scale=hd ** -0.5)[..., :hd].contiguous()


def _launch_band(q, k, v, out, *, window: int, scale: float, stream: int,
                 passes: int = 3) -> int:
    """Both passes of the band build (``passes`` 1: the scores alone, to
    time them apart), one launch a group of :func:`plan_band_groups`,
    through one workspace sized for the largest group.  Returns the first
    nonzero cudaError, else 0."""
    b, s, h, hd = q.shape
    blocks = band_blocks(s, window, q.dtype)
    groups = plan_band_groups(b * h, s, band_item_bytes(s, window, q.dtype))
    rows = max(n for _, n in groups) * BAND_ROWS * blocks
    ws = torch.empty(rows * BAND_KEYS[q.dtype], dtype=torch.float32, device=q.device)
    stats = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    for first, n in groups:
        err = _band()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
                      stats.data_ptr(), b, s, h, k.shape[2], hd, window, scale,
                      int(q.dtype == torch.bfloat16), blocks, first, n, passes, stream)
        if err != 0:
            return err
    return 0


def _launch(q, k, v, *, window: int, scale: float) -> torch.Tensor:
    global LAUNCHES
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    split = split_of(q.dtype, hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if split == BAND:
            err = _launch_band(q, k, v, out, window=window, scale=scale, stream=stream)
        else:
            err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, s, h, k.shape[2], hd, window, scale, int(q.dtype == torch.bfloat16),
                        split, stream)
    if err != 0:
        raise RuntimeError(f"swa_attention: kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    build = build_of(q.dtype, hd)
    BUILD_LAUNCHES[build] = BUILD_LAUNCHES.get(build, 0) + 1
    return out


def swa_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: q (B, S, H, hd),
    k and v (B, S, K, hd), any hd up to :data:`MAX_CHUNKS` slices of
    :data:`CHUNK`, one dtype (float32 or bfloat16),
    contiguous and 16-byte aligned, on one CUDA device, S % 64 == 0 ->
    o (B, S, H, hd) in q's dtype.  Query i attends to the keys j with
    i - window < j <= i.  Raises on anything else, on a failed launch,
    and when grad mode is on and an input requires grad (the kernel has
    no backward, as the Pallas kernel has no ``custom_vjp``)."""
    _check(q, k, v, window)
    return with_padded_head_dim(_launch, q, k, v, window=window)
