"""The MoE's token dispatch on the card, in its two forms, at the shapes
of two steps that ``chip_smoke.py`` runs.

  * rows: the per-row form of ``nn/moe.py`` (``gather_tokens``:
    ``torch.gather`` along each batch row's sequence; ``combine``: one
    ``scatter_add_`` an expert), the form DTensor inputs need;
  * flat: the flat-row form (the (B·S, d) activations indexed by
    ``token + row·S``; one ``index_add_`` an expert), which plain
    tensors took before the per-row form.

Shapes: Mixtral-8x22B's 32,768-token prefill (phase 25: B=1, d=6,144,
E=8, C=10,240, bf16, forward only) and one microbatch of Granite-MoE-
1B-A400M's train step (phase 26: B=2, S=4,096, d=1,024, E=32, C=1,280,
bf16, forward and backward).  Each expert's C tokens of a row are
distinct, as ``expert_choice`` gives them.  Times are medians of CUDA
events over :data:`REPS` calls a form, taken in turns (flat, rows, rows,
flat, ...).  Checked: both forms give the same gathered rows and sums
bitwise, and each form's input gradient is compared with a second
backward of the same form (bitwise or not: several experts' gradients
meet at a token).

    PYTHONPATH=src python tools/moe_dispatch_ab.py [--out FILE]

Prints one JSON object, and writes it to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.nn.moe import combine, gather_tokens  # noqa: E402

REPS = 20
SHAPES = {  # name: (B, S, d, E, C, backward)
    "mixtral_prefill": (1, 32_768, 6_144, 8, 10_240, False),
    "granite_train_microbatch": (2, 4_096, 1_024, 32, 1_280, True),
}


def rows_form(x, xo, token_idx):
    return gather_tokens(x, token_idx), combine(x, xo, token_idx)


def flat_form(x, xo, token_idx):
    b, s, d = x.shape
    e = token_idx.shape[1]
    rows = (token_idx + (torch.arange(b, device=x.device) * s)[:, None, None]).transpose(0, 1)
    rows = rows.reshape(e, -1)
    xin = x.reshape(b * s, d)[rows]
    out = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    for j in range(e):
        out.index_add_(0, rows[j], xo[j])
    return xin, out.reshape(b, s, d)


def inputs(shape, gen):
    b, s, d, e, cap, backward = shape
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    xo = torch.randn((e, b * cap, d), generator=gen, device="cuda").to(torch.bfloat16)
    token_idx = torch.argsort(torch.rand((b, e, s), generator=gen, device="cuda"), dim=-1)
    token_idx = token_idx[..., :cap].contiguous()
    grads = None
    if backward:
        x.requires_grad_()
        xo.requires_grad_()
        grads = (torch.randn((e, b * cap, d), generator=gen, device="cuda").to(torch.bfloat16),
                 torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16))
    return x, xo, token_idx, grads


def call(form, x, xo, token_idx, grads):
    if grads is None:
        with torch.no_grad():
            return form(x, xo, token_idx), None
    x.grad = xo.grad = None
    outs = form(x, xo, token_idx)
    torch.autograd.backward(outs, grads)
    return tuple(t.detach() for t in outs), (x.grad.clone(), xo.grad.clone())


def time_once(form, args) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call(form, *args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_dispatch_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(27)
    forms = {"flat": flat_form, "rows": rows_form}
    result: dict = {"nvidia_smi": card, "torch": torch.__version__, "reps": REPS}
    for name, shape in SHAPES.items():
        ins = inputs(shape, gen)
        (fo, fg), (ro, rg) = call(flat_form, *ins), call(rows_form, *ins)
        row = {"shape": dict(zip(("B", "S", "d", "E", "C", "backward"), shape)),
               "bitwise_forward": all(torch.equal(a, b) for a, b in zip(fo, ro))}
        if fg is not None:
            row["bitwise_xo_grad"] = torch.equal(fg[1], rg[1])
            row["x_grad_max_abs_diff"] = float((fg[0].float() - rg[0].float()).abs().max())
            row["x_grad_repeats_bitwise"] = {
                form: torch.equal(call(fn, *ins)[1][0], call(fn, *ins)[1][0])
                for form, fn in forms.items()}
        for _ in range(3):  # warm both
            for fn in forms.values():
                time_once(fn, ins)
        ms: dict = {form: [] for form in forms}
        for i in range(REPS):
            order = ("flat", "rows") if i % 2 == 0 else ("rows", "flat")
            for form in order:
                ms[form].append(time_once(forms[form], ins))
        for form, times in ms.items():
            row[f"{form}_ms_median"] = sorted(times)[len(times) // 2]
            row[f"{form}_ms"] = times
        row["rows_over_flat"] = row["rows_ms_median"] / row["flat_ms_median"]
        result[name] = row
        del ins
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
