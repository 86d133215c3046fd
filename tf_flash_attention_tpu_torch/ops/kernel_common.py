"""Numeric constants of the attention kernels.

``NEG_INF_F32`` is the finite float32 value of the byte pattern 0xFA
repeated (the JAX package's ``utils/dtypes.py`` masking value), not
``-inf``: a masked logit then gives ``exp2(s - m) == 0``, never NaN, even
when ``m`` is itself the masking value.
"""

import math

import numpy as np

#: The kernels run the online softmax in the log2 domain:
#: ``p = exp2(s * (scale * LOG2E) - m2)``.
LOG2E = float(math.log2(math.e))

NEG_INF_F32 = float(np.frombuffer(b"\xfa" * 4, np.float32)[0])
