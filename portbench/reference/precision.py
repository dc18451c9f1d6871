"""Lower precisions for the controls of `correct`, the same on any
device, so that a control runs in the CPU tests too.

- `RoundedProducts(10)`: TF32, the step below float32 that would tempt a
  later change: every matrix product's float32 operands rounded to 10
  mantissa bits, the products accumulated in float32 as the tensor cores
  do.
- `RoundedOutputs(3)`: fp8 (e4m3), the step below bfloat16: run inside a
  bfloat16 computation (the configuration's mixed precision: bf16
  parameters and features, float32 geometry), every bf16 result rounded
  further to 3 mantissa bits.

Rounding is to nearest, ties away from zero; the exponent range stays
that of the dtype; the gradient passes through a rounding unchanged.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

BITS = {"tf32": 10, "fp8_e4m3": 3}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """`x` (float32) rounded to `bits` mantissa bits."""
    if x.dtype != torch.float32:
        return x
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def round_mantissa_bf16(x: torch.Tensor, bits: int) -> torch.Tensor:
    """`x` (bfloat16) rounded to `bits` mantissa bits."""
    drop = 7 - bits
    i = x.contiguous().view(torch.int16)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.bfloat16)


_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum,
             torch.nn.functional.linear}


class RoundedProducts(TorchFunctionMode):
    """Within this mode every matrix product reads its float32 operands
    rounded to `bits` mantissa bits."""

    def __init__(self, bits: int):
        super().__init__()
        self.bits = bits

    def _r(self, a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            r = round_mantissa(a.detach(), self.bits)
            # the backward passes through the rounding unchanged
            return a + (r - a).detach() if a.requires_grad else r
        if isinstance(a, (list, tuple)):
            return type(a)(self._r(x) for x in a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(self._r(a) for a in args)
        return func(*args, **kwargs)


class RoundedOutputs(TorchFunctionMode):
    """Within this mode every bfloat16 result of a torch function is
    rounded to `bits` mantissa bits (in-place functions excepted: their
    result is their input)."""

    def __init__(self, bits: int):
        super().__init__()
        self.bits = bits

    def _r(self, a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            r = round_mantissa_bf16(a.detach(), self.bits)
            return a + (r - a).detach() if a.requires_grad else r
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "").endswith("_"):
            return out
        if isinstance(out, torch.Tensor):
            return self._r(out)
        if type(out) in (tuple, list):
            return type(out)(self._r(x) for x in out)
        return out
