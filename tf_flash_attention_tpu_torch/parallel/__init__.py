from .mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL, make_mesh  # noqa: F401
from .ring import ring_attention_local, ring_flash_attention  # noqa: F401
from .sharded import mha, sharded_flash_attention  # noqa: F401
from .ulysses import ulysses_attention_local, ulysses_flash_attention  # noqa: F401
