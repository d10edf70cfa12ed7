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

:data:`LAUNCHES` counts each kernel's launches in this process, so a
run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, refuse_autograd

LAUNCHES = {"gossip_mix": 0, "gossip_mix_sparse": 0, "gossip_mix_dp": 0, "gossip_mix_sparse_dp": 0}

TILE_COLS = 1024   # columns per block (kTile in csrc/gossip_mix.cu)
MAX_TILES = 65535  # gridDim.y
MAX_SLOTS = 6144   # a sparse row's (idx, wgt) within 48 KB of shared memory

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gossip_mix": ("gossip_mix_dense_launch", [_P, _P, _P, _P, _I, _L, _P]),
    "gossip_mix_sparse": ("gossip_mix_sparse_launch", [_P, _P, _P, _P, _P, _I, _I, _L, _P]),
    "gossip_mix_dp": ("gossip_mix_dp_launch", [_P, _P, _P, _P, _P, _I, _L, _P]),
    "gossip_mix_sparse_dp": ("gossip_mix_sparse_dp_launch", [_P, _P, _P, _P, _P, _P, _I, _I, _L, _P]),
}
_FNS: dict = {}


def _fn(kernel: str):
    if kernel not in _FNS:
        symbol, argtypes = _SIGNATURES[kernel]
        fn = getattr(_build.load("gossip_mix"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[kernel] = fn
    return _FNS[kernel]


def _check(kernel: str, named: dict[str, torch.Tensor], sparse: bool) -> tuple[int, int, int]:
    """Refuse autograd, then check devices, dtypes, contiguity and
    shapes.  Returns (N, D, S), S the table width (0 when dense)."""
    refuse_autograd(kernel, named)
    check_operands(kernel, named, {"idx": torch.int32})
    w = named["w"]
    if w.dim() != 2:
        raise ValueError(f"{kernel}: w must be (N, D), got {tuple(w.shape)}")
    n, d = w.shape
    if n < 1 or d < 1 or -(-d // TILE_COLS) > MAX_TILES:
        raise ValueError(f"{kernel}: need N >= 1 and 1 <= D <= {TILE_COLS * MAX_TILES}, got N={n} D={d}")
    s = 0
    expect = {"active": (n,), "z": (n, d)}
    if sparse:
        s = named["idx"].shape[-1]
        if not 1 <= s <= MAX_SLOTS:
            raise ValueError(f"{kernel}: the table needs 1 to {MAX_SLOTS} slots per row, got {s}")
        expect.update(idx=(n, s), wgt=(n, s))
    else:
        expect["mix"] = (n, n)
    for name, t in named.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"{kernel}: {name} must be {expect[name]}, got {tuple(t.shape)}")
    return n, d, s


def _launch(kernel: str, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = _fn(kernel)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {err}")
    LAUNCHES[kernel] += 1
    return out


def gossip_mix(mix, w, active) -> torch.Tensor:
    """Dense gossip: ``out[n] = sum_m mix[n, m] w[m]`` where active,
    else ``w[n]``.  mix (N, N), w (N, D), active (N,), float32 on CUDA."""
    n, d, _ = _check("gossip_mix", {"mix": mix, "w": w, "active": active}, sparse=False)
    out = torch.empty_like(w)
    return _launch("gossip_mix", out, mix, w, active, out, n, d)


def gossip_mix_sparse(idx, wgt, w, active) -> torch.Tensor:
    """Sparse gossip: ``out[n] = sum_b wgt[n, b] w[idx[n, b]]`` where
    active, else ``w[n]``.  idx int32 / wgt float32 (N, S), w (N, D)."""
    named = {"idx": idx, "wgt": wgt, "w": w, "active": active}
    n, d, s = _check("gossip_mix_sparse", named, sparse=True)
    out = torch.empty_like(w)
    return _launch("gossip_mix_sparse", out, idx, wgt, w, active, out, n, s, d)


def gossip_mix_dp(mix, w, z, active) -> torch.Tensor:
    """Dense local-DP gossip: ``mix @ (w + z) - diag(mix) z`` where
    active, else ``w``.  z (N, D) is the scaled noise."""
    n, d, _ = _check("gossip_mix_dp", {"mix": mix, "w": w, "z": z, "active": active}, sparse=False)
    out = torch.empty_like(w)
    return _launch("gossip_mix_dp", out, mix, w, z, active, out, n, d)


def gossip_mix_sparse_dp(idx, wgt, w, z, active) -> torch.Tensor:
    """Sparse local-DP gossip: ``sum_b wgt[n, b] (w + z)[idx[n, b]] -
    wgt[n, 0] z[n]`` where active, else ``w[n]``."""
    named = {"idx": idx, "wgt": wgt, "w": w, "z": z, "active": active}
    n, d, s = _check("gossip_mix_sparse_dp", named, sparse=True)
    out = torch.empty_like(w)
    return _launch("gossip_mix_sparse_dp", out, idx, wgt, w, z, active, out, n, s, d)
