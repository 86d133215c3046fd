"""Dtype policy of the attention op (PyTorch port of ``utils/dtypes.py``).

* ``neg_inf_approx(dtype)`` — the finite "negative infinity" masking value:
  the byte pattern 0xFA repeated, read as ``dtype`` (the reference's
  ``TypeUtil<T>::GetNegInfApprox``).  The public ``m`` output of a fully
  masked row holds it.
* ``l_dtype(dtype)`` — the dtype of the softmax normaliser ``l``: float32
  for 2-byte (and narrower) floats, else the input dtype.
* ``canonical_dtype(dtype)`` — validation: the dtypes the op accepts.

The values are the JAX package's, table entry for table entry.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["neg_inf_approx", "l_dtype", "canonical_dtype", "MASK_VALUE_F32"]


def _pattern_value(np_dtype) -> float:
    """Value of the 0xFA-repeated byte pattern read as a numpy float type."""
    return float(np.frombuffer(b"\xfa" * np.dtype(np_dtype).itemsize, np_dtype)[0])


_NEG_INF_TABLE = {
    torch.float16: _pattern_value(np.float16),    # ~ -5.7344e4
    torch.float32: _pattern_value(np.float32),    # ~ -6.5251e35
    torch.float64: _pattern_value(np.float64),    # ~ -4.8357e281
    # bf16 0xFAFA: sign 1, exponent 0xF5, mantissa 0b1111010
    torch.bfloat16: -(1.0 + 0x7A / 128.0) * 2.0 ** 118,
    # fp8 0xFA: e4m3fn -(1 + 2/8)·2^(15-7); e5m2 -1.5·2^15
    torch.float8_e4m3fn: -320.0,
    torch.float8_e5m2: -49152.0,
}

#: masking value inside the kernels, whose logits are always float32
MASK_VALUE_F32 = _NEG_INF_TABLE[torch.float32]


def canonical_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _NEG_INF_TABLE:
        raise TypeError(f"unsupported dtype {dtype}; expected one of "
                        f"{sorted(str(k) for k in _NEG_INF_TABLE)}")
    return dtype


def neg_inf_approx(dtype: torch.dtype) -> float:
    """Finite large-negative masking value for ``dtype`` (reference parity)."""
    return _NEG_INF_TABLE[canonical_dtype(dtype)]


def l_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for half-precision (and fp8) inputs, else the input dtype."""
    dtype = canonical_dtype(dtype)
    return torch.float32 if dtype.itemsize <= 2 else dtype
