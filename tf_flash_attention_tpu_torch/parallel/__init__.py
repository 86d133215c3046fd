from .sharded import mha, sharded_flash_attention  # noqa: F401
