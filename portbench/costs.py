"""The yardstick's constants and cost functions.

The peaks are an H100 SXM's published ones (NVIDIA's data sheet, dense,
at the 700 W limit); a kernel's bytes and operations come from the
shapes it is given.  The peaks and ``lstm_forward_cost`` are frozen
copies of ``chip_smoke.py``'s, so that a change to that script cannot
move the benchmark.  ``window_flops`` is the model's own count, the one
``round_mfu`` uses: the FLOPs one window's forward requires.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # fp32 outside the tensor cores (TF32 off)
BF16_OPS_PER_S = 989e12     # dense, tensor cores


def bound_s(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def lstm_forward_cost(g: int, r: int, steps: int, isz: int, hsz: int) -> tuple[float, float]:
    """Bytes (each operand read once, the output written once) and
    operations of one ``lstm_forward`` launch on x (G, R, L, I) at hidden
    size H: the gate and head FMAs as 2 each, the two adds per gate
    column, and 4 per unit for the c/h update (the 5 transcendentals per
    unit are not counted)."""
    operands = g * r * steps * isz + g * isz * 4 * hsz + g * hsz * 4 * hsz + g * 4 * hsz \
        + g * hsz + g
    nbytes = 4 * (operands + g * r)
    per_step = 2 * (isz + hsz) * 4 * hsz + 2 * 4 * hsz + 4 * hsz
    return nbytes, g * r * (steps * per_step + 2 * hsz + 1)


def gossip_mix_sparse_cost(n: int, d: int, slots: int, active_rows: float) -> tuple[float, float]:
    """Bytes and operations of one sparse gossip mix of the (N, D)
    federation over an (N, S) neighbor table: W read once and the output
    written once, the table (int32 index and float32 weight a slot) and
    the active mask read once; an FMA (2 operations) per slot and column
    of each ACTIVE row (inactive rows are copies)."""
    nbytes = 4 * n * d * 2 + n * slots * 8 + 4 * n
    return nbytes, active_rows * d * 2 * slots


def window_flops(steps: int, isz: int, hsz: int) -> int:
    """FLOPs one window's forward requires: L steps of the two gate
    matmuls, ``2 (I + H) 4H`` each, and the linear head, ``2H``."""
    return steps * 2 * (isz + hsz) * 4 * hsz + 2 * hsz


def train_flops(active_rows: float, batch: int, local_steps: int, steps: int, isz: int,
                hsz: int) -> float:
    """FLOPs one round's local steps require: forward and backward (3
    forwards' worth) of every window of the ACTIVE rows' batches; the
    inactive rows the port computes and then discards are not counted,
    nor are the gossip and the optimizer, which are bound by bandwidth."""
    return 3.0 * active_rows * batch * local_steps * window_flops(steps, isz, hsz)
