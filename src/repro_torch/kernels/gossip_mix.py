"""Wrapper of the hand-written CUDA kernels in ``csrc/gossip_mix.cu``,
the port of the four Pallas kernels in ``repro.kernels.gossip_mix``:

  gossip_mix            dense ``M @ W``             (``gossip_mix_pallas``)
  gossip_mix_sparse     neighbor-table gather-mix   (``gossip_mix_sparse_pallas``)
  gossip_mix_dp         dense local-DP mix          (``gossip_mix_dp_pallas``)
  gossip_mix_sparse_dp  sparse local-DP mix         (``gossip_mix_sparse_dp_pallas``)

Each takes the whole ``(N, D)`` parameter matrix, any N and D (no
padding), and the round's ``(N,)`` active mask: inactive rows come back
as bitwise copies of ``w``.  The output is a new tensor, never ``w``
itself, since every row reads other rows.  Their plain twins are in
``repro_torch.kernels.ref``; the CUDA-or-CPU dispatch is
``repro_torch.kernels.ops``.

Two kernel designs share ``csrc/gossip_mix.cu`` and agree bitwise: the
row-wise kernel (a block a row and 1024 columns, reading the rows it
mixes from global memory) and the column-tile-stationary kernel (a tile
of T columns of every row staged in shared memory once, a persistent
grid walking the tiles).  :func:`_plan` picks one from the shapes:
``gossip_mix``, ``gossip_mix_dp`` and ``gossip_mix_sparse_dp`` stage
while their tile fits in shared memory; ``gossip_mix_sparse`` stays
row-wise.  :func:`gossip_mix_rowwise`, :func:`gossip_mix_dp_rowwise` and
:func:`gossip_mix_sparse_dp_rowwise` launch the row-wise kernel at any
shape, so that checks can hold the staged kernel against it; nothing on
the training path calls them.

:data:`LAUNCHES` counts each kernel's launches in this process, so a
run can show that its path went through the kernels
(:data:`ROWWISE_LAUNCHES` counts the three comparison wrappers').
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, refuse_autograd

LAUNCHES = {"gossip_mix": 0, "gossip_mix_sparse": 0, "gossip_mix_dp": 0, "gossip_mix_sparse_dp": 0}
ROWWISE_LAUNCHES = {"gossip_mix": 0, "gossip_mix_dp": 0, "gossip_mix_sparse_dp": 0}

STAGED = ("gossip_mix", "gossip_mix_dp", "gossip_mix_sparse_dp")  # the kernels with a staged design
ROW_TILE = 1024              # the row-wise kernel's columns a block (kTile)
MAX_ROW_TILES = 65535        # its tiles along gridDim.y
MAX_SLOTS = 6144             # its sparse row's (idx, wgt) within 48 KB of shared memory
SMEM_LIMIT = 232_448         # dynamic shared memory a block may opt into on sm_90
# The staged kernel's tile width and block size, the fastest measured on
# an H100 at the main path's shapes (PERF.md): N=12 dense mixes a 256-column
# tile (1 KB of each row) with a thread per 4 x 4 outputs; so does N=12
# dense DP (chip_smoke.py phase 12 times T = 64 to 512: 256 columns with
# 256 threads had the lowest event time in each run, 512 with 512 the
# same device time; staged up to N=95); N=226 sparse DP a 32-column tile,
# 72 KB with its table, so that three blocks of 512 threads share an SM
# and one loads while the others compute.
STAGED_TILE = {"gossip_mix": 256, "gossip_mix_dp": 256, "gossip_mix_sparse_dp": 32}
STAGED_THREADS = {"gossip_mix": 256, "gossip_mix_dp": 256, "gossip_mix_sparse_dp": 512}


class Plan(NamedTuple):
    design: str   # "staged" or "rowwise"
    tile: int     # columns a block mixes at a time
    threads: int  # threads a block
    smem: int     # dynamic shared memory of a block, bytes


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _smem_bytes(n: int, s: int, tile: int, sparse: bool, dp: bool) -> int:
    """Shared memory of a staged block (``StagedLayout`` in the CUDA
    source): the operator -- the table's idx and wgt rows padded to a
    multiple of 4 slots, or M^T with rows of round4(N) -- the active
    mask, and the tile, W's (and for DP Z's) N x T columns."""
    op = 2 * n * _round4(s) if sparse else n * _round4(n)
    return 4 * (op + _round4(n) + n * tile * (2 if dp else 1))


def _plan(kernel: str, n: int, s: int, d: int) -> Plan:
    """The design for ``kernel`` at N rows, S table slots (0 when dense)
    and D columns: the staged kernel at its tile while the tile and the
    operator fit in a block's shared memory, else (and for the kernels
    without a staged design) the row-wise kernel.  D does not enter:
    the staged grid walks the tiles."""
    if kernel in STAGED:
        tile = STAGED_TILE[kernel]
        smem = _smem_bytes(n, s, tile, "sparse" in kernel, kernel.endswith("_dp"))
        if smem <= SMEM_LIMIT:
            return Plan("staged", tile, STAGED_THREADS[kernel], smem)
    return Plan("rowwise", ROW_TILE, 256, 8 * s)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # C symbol -> argument types, the stream last
    "gossip_mix_dense_launch": [_P, _P, _P, _P, _I, _L, _I, _I, _P],
    "gossip_mix_rowwise_launch": [_P, _P, _P, _P, _I, _L, _P],
    "gossip_mix_sparse_launch": [_P, _P, _P, _P, _P, _I, _I, _L, _P],
    "gossip_mix_dp_launch": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _P],
    "gossip_mix_dp_rowwise_launch": [_P, _P, _P, _P, _P, _I, _L, _P],
    "gossip_mix_sparse_dp_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P],
    "gossip_mix_sparse_dp_rowwise_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _P],
}
_FNS: dict = {}


def _fn(symbol: str):
    if symbol not in _FNS:
        fn = getattr(_build.load("gossip_mix"), symbol)
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return _FNS[symbol]


def _check(kernel: str, named: dict[str, torch.Tensor], sparse: bool) -> tuple[int, int, int]:
    """Refuse autograd, then check devices, dtypes, contiguity and
    shapes.  Returns (N, D, S), S the table width (0 when dense)."""
    refuse_autograd(kernel, named)
    check_operands(kernel, named, {"idx": torch.int32})
    w = named["w"]
    if w.dim() != 2:
        raise ValueError(f"{kernel}: w must be (N, D), got {tuple(w.shape)}")
    n, d = w.shape
    if n < 1 or d < 1:
        raise ValueError(f"{kernel}: need N >= 1 and D >= 1, got N={n} D={d}")
    s = 0
    expect = {"active": (n,), "z": (n, d)}
    if sparse:
        s = named["idx"].shape[-1]
        if s < 1:
            raise ValueError(f"{kernel}: the table needs at least 1 slot per row, got {s}")
        expect.update(idx=(n, s), wgt=(n, s))
    else:
        expect["mix"] = (n, n)
    for name, t in named.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"{kernel}: {name} must be {expect[name]}, got {tuple(t.shape)}")
    return n, d, s


def _check_rowwise(kernel: str, n: int, s: int, d: int) -> None:
    """What the row-wise kernel takes beyond :func:`_check` (the staged
    kernel's limit, shared memory, is its plan's)."""
    if -(-d // ROW_TILE) > MAX_ROW_TILES:
        raise ValueError(f"{kernel}: need D <= {ROW_TILE * MAX_ROW_TILES} on the row-wise "
                         f"kernel, got N={n} D={d}")
    if s > MAX_SLOTS:
        raise ValueError(f"{kernel}: the row-wise kernel takes 1 to {MAX_SLOTS} slots per "
                         f"row, got {s}")


def _launch(kernel: str, counts: dict, symbol: str, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = _fn(symbol)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {err} ({symbol})")
    counts[kernel] += 1
    return out


def gossip_mix(mix, w, active) -> torch.Tensor:
    """Dense gossip: ``out[n] = sum_m mix[n, m] w[m]`` where active,
    else ``w[n]``.  mix (N, N), w (N, D), active (N,), float32 on CUDA."""
    n, d, _ = _check("gossip_mix", {"mix": mix, "w": w, "active": active}, sparse=False)
    plan = _plan("gossip_mix", n, 0, d)
    out = torch.empty_like(w)
    if plan.design == "staged":
        return _launch("gossip_mix", LAUNCHES, "gossip_mix_dense_launch", out,
                       mix, w, active, out, n, d, plan.tile, plan.threads)
    _check_rowwise("gossip_mix", n, 0, d)
    return _launch("gossip_mix", LAUNCHES, "gossip_mix_rowwise_launch", out, mix, w, active, out, n, d)


def gossip_mix_sparse(idx, wgt, w, active) -> torch.Tensor:
    """Sparse gossip: ``out[n] = sum_b wgt[n, b] w[idx[n, b]]`` where
    active, else ``w[n]``.  idx int32 / wgt float32 (N, S), w (N, D)."""
    named = {"idx": idx, "wgt": wgt, "w": w, "active": active}
    n, d, s = _check("gossip_mix_sparse", named, sparse=True)
    _check_rowwise("gossip_mix_sparse", n, s, d)
    out = torch.empty_like(w)
    return _launch("gossip_mix_sparse", LAUNCHES, "gossip_mix_sparse_launch", out,
                   idx, wgt, w, active, out, n, s, d)


def gossip_mix_dp(mix, w, z, active) -> torch.Tensor:
    """Dense local-DP gossip: ``mix @ (w + z) - diag(mix) z`` where
    active, else ``w``.  z (N, D) is the scaled noise."""
    n, d, _ = _check("gossip_mix_dp", {"mix": mix, "w": w, "z": z, "active": active}, sparse=False)
    plan = _plan("gossip_mix_dp", n, 0, d)
    out = torch.empty_like(w)
    if plan.design == "staged":
        return _launch("gossip_mix_dp", LAUNCHES, "gossip_mix_dp_launch", out,
                       mix, w, z, active, out, n, d, plan.tile, plan.threads)
    _check_rowwise("gossip_mix_dp", n, 0, d)
    return _launch("gossip_mix_dp", LAUNCHES, "gossip_mix_dp_rowwise_launch", out,
                   mix, w, z, active, out, n, d)


def gossip_mix_sparse_dp(idx, wgt, w, z, active) -> torch.Tensor:
    """Sparse local-DP gossip: ``sum_b wgt[n, b] (w + z)[idx[n, b]] -
    wgt[n, 0] z[n]`` where active, else ``w[n]``."""
    named = {"idx": idx, "wgt": wgt, "w": w, "z": z, "active": active}
    n, d, s = _check("gossip_mix_sparse_dp", named, sparse=True)
    plan = _plan("gossip_mix_sparse_dp", n, s, d)
    out = torch.empty_like(w)
    if plan.design == "staged":
        return _launch("gossip_mix_sparse_dp", LAUNCHES, "gossip_mix_sparse_dp_launch", out,
                       idx, wgt, w, z, active, out, n, s, d, plan.tile, plan.threads)
    _check_rowwise("gossip_mix_sparse_dp", n, s, d)
    return _launch("gossip_mix_sparse_dp", LAUNCHES, "gossip_mix_sparse_dp_rowwise_launch", out,
                   idx, wgt, w, z, active, out, n, s, d)


def gossip_mix_rowwise(mix, w, active) -> torch.Tensor:
    """:func:`gossip_mix` on the row-wise kernel whatever the shape (a
    comparison for checks; counted in :data:`ROWWISE_LAUNCHES`)."""
    n, d, _ = _check("gossip_mix", {"mix": mix, "w": w, "active": active}, sparse=False)
    _check_rowwise("gossip_mix", n, 0, d)
    out = torch.empty_like(w)
    return _launch("gossip_mix", ROWWISE_LAUNCHES, "gossip_mix_rowwise_launch", out,
                   mix, w, active, out, n, d)


def gossip_mix_dp_rowwise(mix, w, z, active) -> torch.Tensor:
    """:func:`gossip_mix_dp` on the row-wise kernel whatever the shape (a
    comparison for checks; counted in :data:`ROWWISE_LAUNCHES`)."""
    n, d, _ = _check("gossip_mix_dp", {"mix": mix, "w": w, "z": z, "active": active}, sparse=False)
    _check_rowwise("gossip_mix_dp", n, 0, d)
    out = torch.empty_like(w)
    return _launch("gossip_mix_dp", ROWWISE_LAUNCHES, "gossip_mix_dp_rowwise_launch", out,
                   mix, w, z, active, out, n, d)


def gossip_mix_sparse_dp_rowwise(idx, wgt, w, z, active) -> torch.Tensor:
    """:func:`gossip_mix_sparse_dp` on the row-wise kernel whatever the
    shape (a comparison for checks; counted in :data:`ROWWISE_LAUNCHES`)."""
    named = {"idx": idx, "wgt": wgt, "w": w, "z": z, "active": active}
    n, d, s = _check("gossip_mix_sparse_dp", named, sparse=True)
    _check_rowwise("gossip_mix_sparse_dp", n, s, d)
    out = torch.empty_like(w)
    return _launch("gossip_mix_sparse_dp", ROWWISE_LAUNCHES, "gossip_mix_sparse_dp_rowwise_launch",
                   out, idx, wgt, w, z, active, out, n, s, d)
