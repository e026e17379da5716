"""The LM substrate's models (the port of ``repro.models``): what is
ported is ``attention``, ``layers``, ``ssm``, ``transformer`` and ``zoo``
(every family but MoE and enc-dec), and ``convert`` carries the
reference's weights across. ``moe``, ``encdec``, ``flash_vjp``, ``policy``
and ``unroll`` are not ported yet (ROADMAP.md, port order item 8)."""
from . import attention, convert, layers, ssm, transformer, zoo

__all__ = ["attention", "convert", "layers", "ssm", "transformer", "zoo"]
