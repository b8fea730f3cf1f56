"""How the reference computes its products.

``"f32"``: float32 with TF32 off, the reference itself. The control of a
cell is the reference one precision below what the configuration states:
``"tf32"`` (float32 products on TF32 tensor cores) for a part stated in
float32, ``"fp8"`` (both operands of every product rounded to float8
e4m3 with one scale a tensor, the sum in float32) for a part stated in
bfloat16. In a training step the backward products of the control are
float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 products and convolutions on or off inside."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


class Prec:
    """The products of one part of the model in one of ``MODES``."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as the product sees it (in a backward pass the fp8
        rounding passes the gradient straight through)."""
        t = t.float()
        if self.mode != "fp8":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return t + ((t.detach() / scale).to(torch.float8_e4m3fn).float() * scale - t.detach())

    def ctx(self):
        return tf32(self.mode == "tf32")

    def linear(self, x, w, b=None):
        with self.ctx():
            y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b.float()

    def einsum(self, eq, a, b):
        with self.ctx():
            return torch.einsum(eq, self.q(a), self.q(b))

    def conv1d(self, x, w, b=None, stride=1, padding=0, groups=1):
        """(N, C, L) channels-first."""
        with self.ctx():
            return F.conv1d(self.q(x), self.q(w), None if b is None else b.float(), stride, padding, 1, groups)
