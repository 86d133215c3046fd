"""Weight-only int8 quantization (PyTorch port of ``ops/quant.py``).

Symmetric int8 codes with float32 scales: ``quantize_int8`` along one axis,
``quantize_weight_int8`` per output channel of an ``(in, out)`` weight, and
``int8_matmul``, which quantizes ``x`` per row on the fly, multiplies the
codes with int32 accumulation and applies both scales to the int32 result.
The JAX package computes this product with ``jnp`` (no Pallas kernel), so
on the card it is ``torch._int_mm`` (int8 x int8 -> int32); shapes that
``_int_mm`` refuses raise there.  On the CPU the accumulators come from a
float64 product, exact as the int32 one is: every partial sum is an integer
of at most 127^2 * in < 2^31 in magnitude.

Divisions take a tensor divisor: on CUDA, division by a Python scalar is a
multiply by its reciprocal, which is not the IEEE quotient the JAX package
takes eagerly; so the codes and scales equal the JAX package's bit for bit
on either device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantizedTensor", "quantize_int8", "dequantize_int8",
           "quantize_weight_int8", "int8_matmul"]

_QMAX = 127.0


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload and float32 scales broadcastable against it."""

    values: torch.Tensor    # int8
    scales: torch.Tensor    # float32, values.shape with the quantized axis -> 1

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return torch.int8



def quantize_int8(x: torch.Tensor, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-slice int8 quantization along ``axis``; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, _QMAX))
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return QuantizedTensor(values=q, scales=scale)


def dequantize_int8(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (qt.values.float() * qt.scales).to(dtype)


def quantize_weight_int8(w: torch.Tensor) -> QuantizedTensor:
    """Weight-only int8: per-output-channel scales for ``(in, out)`` weights."""
    return quantize_int8(w, axis=0)


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32 accumulators."""
    if a.device.type == "cuda":
        return torch._int_mm(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(x: torch.Tensor, qw: QuantizedTensor, *,
                return_parts: bool = False):
    """``x @ dequant(qw)`` with the dequantization after the integer product:
    ``x`` (..., in) quantized per row, codes multiplied with int32
    accumulation, then ``acc * x_scale * w_scale`` in float32, cast to
    ``x.dtype``.  ``return_parts`` also returns the row codes (a
    ``QuantizedTensor``) and the int32 accumulators."""
    qx = quantize_int8(x, axis=-1)
    lead = x.shape[:-1]
    acc = _int8_product(qx.values.reshape(-1, x.shape[-1]), qw.values)
    acc = acc.reshape(*lead, -1)
    out = (acc.float() * qx.scales * qw.scales.reshape(1, -1)).to(x.dtype)
    return (out, qx, acc) if return_parts else out
