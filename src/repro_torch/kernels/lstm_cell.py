"""Wrapper of the hand-written CUDA kernel ``lstm_forward``
(``csrc/lstm_forward.cu``), the port of the Pallas kernel
``repro.kernels.lstm_cell.lstm_cell_pallas``.

The Pallas kernel computes one LSTM step and leaves the time loop to a
``lax.scan``.  The CUDA kernel runs all L steps and the linear head in
one launch, with one weight set per group: serving calls it with one
group per request (its own param row) and R=1.  Its plain twin is
``repro_torch.kernels.ref.lstm_forward_plain``; the dispatch between the
two is ``repro_torch.kernels.ops.lstm_forward``.

:data:`LAUNCHES` counts the kernel's launches in this process, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, refuse_autograd

LAUNCHES = 0

# the kernel keeps h, c and the 4H gate pre-activations in shared memory
# (6H floats), within the 48 KB a block gets without opting in
MAX_HIDDEN = 48 * 1024 // (6 * 4)

_launch_fn = None


def _fn():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("lstm_forward").lstm_forward_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    y (G, R).  Raises on anything else, on a failed launch, and when
    grad mode is on and an input requires grad (the kernel has no
    backward: the trainer's loss goes through the plain forward)."""
    global LAUNCHES
    g, r, steps, isz, hsz = _check(x, wx, wh, b, w_out, b_out)
    y = torch.empty((g, r), dtype=torch.float32, device=x.device)
    if g * r == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), y.data_ptr(),
            g, r, steps, isz, hsz, stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_forward: kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    return y
