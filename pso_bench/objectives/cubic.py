"""Paper Eq. 3, the cubic, maximized over [-100, 100]^D: the sum over the
dimensions of x^3 - 0.8 x^2 - 1000 x + 8000. The port's built-in
``"cubic"``; its optimum is the box's corner x = 100, 900000 a dimension.

An objective file gives what the solve call names (``problem``), the
objective in float32 as the reference evaluates it (``f32``: each operation
rounded, in the order of the formula), in float64 with the sum of its
terms' magnitudes (``f64``: the scale a float32 evaluation rounds against),
and its float operations an element (``FP_OPS``) for the kernels' counted
bound.
"""
import torch

#: x*x, x*x*x, 0.8 times x*x, 1000 times x, two subtractions, the add of
#: 8000 and the accumulation over the dimensions.
FP_OPS = 8


def problem():
    """The objective as the solve call names it: the port's built-in."""
    return "cubic"


def f32(pos: torch.Tensor) -> torch.Tensor:
    x = pos
    return torch.sum(x * x * x - 0.8 * (x * x) - 1000.0 * x + 8000.0,
                     dim=-1)


def f64(pos: torch.Tensor):
    x = pos.to(torch.float64)
    terms = (x ** 3, 0.8 * x * x, 1000.0 * x, torch.full_like(x, 8000.0))
    value = torch.sum(terms[0] - terms[1] - terms[2] + terms[3], dim=-1)
    scale = sum(torch.sum(t.abs(), dim=-1) for t in terms)
    return value, scale
