"""Operand rounding of the reference's convolutions and dense layers.

`exact` leaves float32 as it is. `fp8` is the control: every operand of
a conv or dense layer (activations and weights) rounded to float8 e4m3
under a per-tensor scale (its largest magnitude to 448), the step below
the configurations' bfloat16; in training the rounding passes the
gradient straight through and the backward computes on the rounded
operands the forward saved."""

import torch

E4M3_MAX = 448.0


def exact(t):
    return t


def fp8(t):
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


QUANTS = {"exact": exact, "fp8": fp8}
