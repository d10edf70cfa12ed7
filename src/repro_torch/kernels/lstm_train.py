"""Wrapper of the hand-written CUDA kernels ``lstm_gates_fwd`` and
``lstm_gates_bwd`` (``csrc/lstm_train.cu``): one step of the trainer's
LSTM, the gates and the cell update, forward and backward, in one launch
each.  They port no Pallas kernel: the JAX package trains through its
plain ``jnp`` cell under ``jax.grad``.  The trainer's backpropagation
through time, ``models/lstm.py:LSTMModel.forward_for_grad``, calls
them between its ``torch.bmm`` products, once a step each way.

Both work in place on ``(N, B, cols)`` views with unit stride along
``cols`` (the step slices of the trainer's ``(N, L, B, .)`` buffers);
``wx``, ``b``, ``db`` and ``dwx`` are the leaves' views into the
``(N, D)`` parameter and gradient buffers.  They take one input a step
(I = 1, the port's configurations); at I > 1 the caller folds ``x wx``
into the gate buffer and takes ``dwx`` with one product over all steps,
and passes None for ``x``, ``wx`` and ``dwx``.  Their plain twins are
``repro_torch.kernels.ref.lstm_gates_fwd_plain`` and
``lstm_gates_bwd_plain``; the dispatch between the two is
``repro_torch.kernels.ops``.

:data:`LAUNCHES` counts each kernel's launches in this process: L of
each a local step of an L-step window, which shows that the trainer's
step went through them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_rows, refuse_autograd

LAUNCHES = {"lstm_gates_fwd": 0, "lstm_gates_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_S = ctypes.c_longlong
_ARGTYPES = {
    "lstm_gates_fwd_launch": [_P, _S, _S, _P, _S, _S, _P, _S, _P, _S, _P, _P, _S, _S, _P, _S, _S,
                              _I, _I, _I, _I, _P],
    "lstm_gates_bwd_launch": [_P, _S, _S, _P, _P, _S, _S, _P, _P, _S, _S, _P, _S, _S, _P, _S, _P,
                              _S, _I, _I, _I, _I, _I, _P],
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str):
    if name not in _fns:
        fn = getattr(_build.load("lstm_train"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _expect(kernel: str, named: dict[str, torch.Tensor], shapes: dict[str, tuple]) -> None:
    for name, shape in shapes.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{kernel}: {name} must be {shape}, got {tuple(named[name].shape)}")


def _vec(hsz: int, rows: list[torch.Tensor]) -> int:
    """1 (four units a thread, 16-byte accesses) when H % 4 == 0 and every
    ``(N, B, .)`` operand starts on 16 bytes with strides of whole float4s."""
    return int(hsz % 4 == 0 and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                                    and t.stride(1) % 4 == 0 for t in rows))


def _launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = _fn(fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {err}")
    LAUNCHES[kernel] += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _strides(t, dims: int) -> tuple[int, ...]:
    return (0,) * dims if t is None else t.stride()[:dims]


def lstm_gates_fwd(gates, x, wx, b, c_prev, c, h) -> None:
    """Step t of the LSTM's forward, in place: ``gates`` (N, B, 4H) holds
    ``h_{t-1} @ wh`` (not read when ``c_prev`` is None and ``x`` is
    given: step 0, zero state) and comes back as the activated
    (i, f, g, o) of ``gates + x @ wx + b``; ``c`` and ``h`` (N, B, H)
    receive ``c_t`` and ``h_t``.  x (N, B, 1) and wx (N, 1, 4H), or both
    None when ``gates`` already holds ``x_t @ wx`` (I > 1: the caller's
    product over all steps); b (N, 4H), c_prev (N, B, H) or None.  One
    launch on the current stream; raises on anything the kernel does not
    take and on a failed launch."""
    named = {k: t for k, t in (("gates", gates), ("x", x), ("wx", wx), ("b", b), ("c", c),
                               ("h", h), ("c_prev", c_prev)) if t is not None}
    refuse_autograd("lstm_gates_fwd", named)
    device = check_rows("lstm_gates_fwd", named)
    n, bsz, hsz = gates.shape[0], gates.shape[1], c.shape[-1]
    if (x is None) != (wx is None):
        raise ValueError("lstm_gates_fwd: x and wx come together or not at all")
    _expect("lstm_gates_fwd", named, {
        "gates": (n, bsz, 4 * hsz), "x": (n, bsz, 1), "wx": (n, 1, 4 * hsz), "b": (n, 4 * hsz),
        "c": (n, bsz, hsz), "h": (n, bsz, hsz), "c_prev": (n, bsz, hsz)})
    if c_prev is not None and c_prev.stride() != c.stride():
        raise ValueError("lstm_gates_fwd: c_prev and c must share their strides")
    rows = [gates, c, h] + ([c_prev] if c_prev is not None else [])
    _launch("lstm_gates_fwd", "lstm_gates_fwd_launch", device,
            gates.data_ptr(), gates.stride(0), gates.stride(1), _ptr(x), *_strides(x, 2),
            _ptr(wx), *_strides(wx, 1), b.data_ptr(), b.stride(0), _ptr(c_prev),
            c.data_ptr(), c.stride(0), c.stride(1), h.data_ptr(), h.stride(0), h.stride(1),
            n, bsz, hsz, _vec(hsz, rows))


def lstm_gates_bwd(gates, c_prev, c, dh, dc, x, db, dwx, accumulate: bool) -> None:
    """Step t of the LSTM's backward, in place: from the activated gates
    (N, B, 4H) of step t, ``c_prev`` = c_{t-1} (None at step 0),
    ``c`` = c_t, ``dh`` = dL/dh_t and ``dc`` = dL/dc_t through step t+1
    (all (N, B, H)), ``gates`` comes back as dL/d(pre-activation) and
    ``dc`` as dL/dc_{t-1}.  ``db`` (N, 4H) and ``dwx`` (N, 1, 4H) receive
    the step's ``sum_b dG`` and ``x^T dG`` (x (N, B, 1)), added to what
    they hold when ``accumulate``; x and dwx are None together when the
    caller takes dwx itself (I > 1).  One launch on the current
    stream."""
    named = {k: t for k, t in (("gates", gates), ("c", c), ("dh", dh), ("dc", dc), ("x", x),
                               ("db", db), ("dwx", dwx), ("c_prev", c_prev)) if t is not None}
    refuse_autograd("lstm_gates_bwd", named)
    device = check_rows("lstm_gates_bwd", named)
    n, bsz, hsz = gates.shape[0], gates.shape[1], c.shape[-1]
    if (x is None) != (dwx is None):
        raise ValueError("lstm_gates_bwd: x and dwx come together or not at all")
    _expect("lstm_gates_bwd", named, {
        "gates": (n, bsz, 4 * hsz), "c": (n, bsz, hsz), "c_prev": (n, bsz, hsz),
        "dh": (n, bsz, hsz), "dc": (n, bsz, hsz), "x": (n, bsz, 1), "db": (n, 4 * hsz),
        "dwx": (n, 1, 4 * hsz)})
    if c_prev is not None and c_prev.stride() != c.stride():
        raise ValueError("lstm_gates_bwd: c_prev and c must share their strides")
    if dh.stride() != dc.stride():
        raise ValueError("lstm_gates_bwd: dh and dc must share their strides")
    rows = [gates, c, dh, dc] + ([c_prev] if c_prev is not None else [])
    _launch("lstm_gates_bwd", "lstm_gates_bwd_launch", device,
            gates.data_ptr(), gates.stride(0), gates.stride(1), _ptr(c_prev),
            c.data_ptr(), c.stride(0), c.stride(1), dh.data_ptr(), dc.data_ptr(),
            dh.stride(0), dh.stride(1), _ptr(x), *_strides(x, 2), db.data_ptr(), db.stride(0),
            _ptr(dwx), *_strides(dwx, 1), n, bsz, hsz, int(accumulate), _vec(hsz, rows))
