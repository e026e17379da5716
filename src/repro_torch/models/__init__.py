"""The LM substrate's models (the port of ``repro.models``):
``attention``, ``layers``, ``ssm``, ``moe``, ``flash_vjp``, ``encdec``,
``transformer`` and ``zoo``; ``convert`` carries the reference's weights
across. ``unroll`` keeps the reference's scan switch (``maybe_scan`` is a
Python loop in eager torch), and ``policy`` its activation-sharding hints,
which are the identity on one card."""
from . import (attention, convert, encdec, flash_vjp, layers, moe, policy,
               ssm, transformer, unroll, zoo)

__all__ = ["attention", "convert", "encdec", "flash_vjp", "layers", "moe",
           "policy", "ssm", "transformer", "unroll", "zoo"]
