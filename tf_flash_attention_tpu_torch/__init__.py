"""PyTorch/CUDA port of ``tf_flash_attention_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module paths (``serving/decode.py``, ``serving/kv_cache.py``, ...) so each
counterpart is easy to find.  It imports ``torch`` and numpy and never
``jax``.  The first slice is the serving path: the continuous-batching
engine over a paged (optionally int8) KV cache, whose four attention and
cache-write kernels are hand-written CUDA for Hopper (``csrc/``, built by
``native.py`` on first use).
"""

from .mask_rules import CausalRule, FullRule, LocalRule, make_rule  # noqa: F401
from .sync_modes import SYNC_MODES, make_sync_pack  # noqa: F401

__version__ = "0.1.0"
