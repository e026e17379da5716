"""The LM substrate's models (the port of ``repro.models``):
``attention``, ``layers``, ``ssm``, ``moe``, ``flash_vjp``, ``encdec``,
``transformer`` and ``zoo``; ``convert`` carries the reference's weights
across. ``policy`` and ``unroll`` are not ported yet (ROADMAP.md, port
order item 8(c)); ``policy``'s sharding hints are the identity on one
device."""
from . import (attention, convert, encdec, flash_vjp, layers, moe, ssm,
               transformer, zoo)

__all__ = ["attention", "convert", "encdec", "flash_vjp", "layers", "moe",
           "ssm", "transformer", "zoo"]
