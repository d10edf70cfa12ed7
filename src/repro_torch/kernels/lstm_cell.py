"""Wrapper of the hand-written CUDA kernel ``lstm_forward``
(``csrc/lstm_forward.cu``), the port of the Pallas kernel
``repro.kernels.lstm_cell.lstm_cell_pallas``.

The Pallas kernel computes one LSTM step and leaves the time loop to a
``lax.scan``.  The CUDA kernel runs all L steps and the linear head in
one launch, with one weight set per group: serving calls it with one
group per request (its own param row) and R=1; evaluation with one
group and R = the windows.  Its plain twin is
``repro_torch.kernels.ref.lstm_forward_plain``; the dispatch between the
two is ``repro_torch.kernels.ops.lstm_forward``.

:func:`_plan` picks the kernel's path from the shapes: a cluster of C
CTAs holding one group's weights on chip (in registers at H=128, else in
shared memory) for a tile of T rows, or, above the largest H a cluster
of 8 can hold, the streaming kernel.  Every path computes each row in
the same order, so the path changes no bit of the output.

:data:`LAUNCHES` counts the kernel's launches in this process, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, refuse_autograd

LAUNCHES = 0

# the streaming kernel keeps h, c and the 4H gate pre-activations in
# shared memory (6H floats), within the 48 KB a block gets without opting in
MAX_HIDDEN = 48 * 1024 // (6 * 4)

CLUSTERS = (1, 2, 4, 8)  # portable cluster sizes, smallest first
TILE = 8                 # most rows of one group a cluster runs (fits registers at H=128)
REG_HIDDEN = 128         # the H whose weights the kernel keeps in registers
SMEM_LIMIT = 232_448     # dynamic shared memory a block may opt into on sm_90
# csrc/lstm_forward.cu: kBarBytes (mbarriers), kChunks (k-chunks of a
# shared-memory wh slice)
_BARRIER_BYTES, _CHUNKS = 128, 4
UNSCHEDULABLE = -1       # what the launcher returns for a cluster that cannot run


class Plan(NamedTuple):
    cluster: int  # CTAs a cluster; 0: the streaming kernel
    tile: int     # rows of one group a cluster runs (1 on the streaming kernel)
    weights: str  # where a CTA keeps its wh slice: "registers", "shared" or "streamed"
    smem: int     # dynamic shared memory of a block, bytes


def _smem_bytes(hsz: int, isz: int, cluster: int, tile: int, weights: str) -> int:
    """Shared memory of a cluster CTA (``layout`` in the CUDA source):
    its wh slice (none in registers; whole k-chunks of 4-row multiples
    in shared memory), wx and b columns, h double-buffered by step
    parity for the tile's rows, their c and activated gates."""
    hc = -(-hsz // cluster)
    nc, hp = 4 * hc, -(-hsz // 4) * 4
    chunk = (-(-hsz // _CHUNKS) + 3) // 4 * 4
    w_rows = 0 if weights == "registers" else _CHUNKS * chunk
    floats = (w_rows + isz + 1) * nc + 2 * tile * hp + tile * hc + tile * nc
    return _BARRIER_BYTES + 4 * floats


def _plan(g: int, r: int, steps: int, isz: int, hsz: int) -> Plan:
    """The kernel's path for x (G, R, L, I) at hidden size H.

    At H = ``REG_HIDDEN`` a cluster of 2 keeps wh in registers (one
    column of 128 weights a thread; 1 CTA would need 512 such threads,
    more than the register file holds).  Otherwise the cluster size is
    the smallest whose shared-memory slice fits beside a full tile's
    state; above the largest H a cluster of 8 holds, the streaming
    kernel.  So the path depends on H and I alone, never on G or R.  The
    tile is the least power of two that holds R rows, at most ``TILE``."""
    tile = min(TILE, 1 << max(r - 1, 0).bit_length())
    if hsz == REG_HIDDEN and _smem_bytes(hsz, isz, 2, TILE, "registers") <= SMEM_LIMIT:
        return Plan(2, tile, "registers", _smem_bytes(hsz, isz, 2, tile, "registers"))
    for cluster in CLUSTERS:
        if _smem_bytes(hsz, isz, cluster, TILE, "shared") <= SMEM_LIMIT:
            return Plan(cluster, tile, "shared", _smem_bytes(hsz, isz, cluster, tile, "shared"))
    return Plan(0, 1, "streamed", 6 * hsz * 4)


_launch_fn = None


def _fn():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("lstm_forward").lstm_forward_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check(x, wx, wh, b, w_out, b_out) -> tuple[int, int, int, int, int]:
    named = {"x": x, "wx": wx, "wh": wh, "b": b, "w_out": w_out, "b_out": b_out}
    refuse_autograd("lstm_forward", named)
    check_operands("lstm_forward", named)
    if x.dim() != 4:
        raise ValueError(f"lstm_forward: x must be (G, R, L, I), got {tuple(x.shape)}")
    g, r, steps, isz = x.shape
    hsz = wh.shape[1] if wh.dim() == 3 else -1
    expect = {
        "wx": (g, isz, 4 * hsz), "wh": (g, hsz, 4 * hsz), "b": (g, 4 * hsz),
        "w_out": (g, hsz, 1), "b_out": (g, 1),
    }
    for name, shape in expect.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"lstm_forward: {name} must be {shape}, got {tuple(named[name].shape)}")
    if min(steps, isz, hsz) < 1 or hsz > MAX_HIDDEN:
        raise ValueError(f"lstm_forward: need L, I >= 1 and 1 <= H <= {MAX_HIDDEN}, got L={steps} I={isz} H={hsz}")
    return g, r, steps, isz, hsz


def lstm_forward(x, wx, wh, b, w_out, b_out) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: x (G, R, L, I),
    wx (G, I, 4H), wh (G, H, 4H), b (G, 4H), w_out (G, H, 1),
    b_out (G, 1), all float32, contiguous and on one CUDA device ->
    y (G, R), one launch on the path :func:`_plan` picks.  Raises on
    anything else, on a failed launch, on a cluster the card cannot
    schedule (nothing is launched then), and when grad mode is on and an
    input requires grad (the kernel has no backward: the trainer's loss
    goes through the plain forward)."""
    global LAUNCHES
    g, r, steps, isz, hsz = _check(x, wx, wh, b, w_out, b_out)
    y = torch.empty((g, r), dtype=torch.float32, device=x.device)
    if g * r == 0:
        return y
    plan = _plan(g, r, steps, isz, hsz)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), y.data_ptr(),
            g, r, steps, isz, hsz, plan.cluster, plan.tile, plan.weights == "registers", stream,
        )
    if err == UNSCHEDULABLE:
        raise RuntimeError(f"lstm_forward: a cluster of {plan.cluster} CTAs with "
                           f"{plan.smem} bytes of shared memory each cannot be scheduled")
    if err != 0:
        raise RuntimeError(f"lstm_forward: kernel launch failed with cudaError {err} ({plan})")
    LAUNCHES += 1
    return y
