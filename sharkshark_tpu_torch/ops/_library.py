"""The port's kernels as torch operators in the `sharkshark` namespace
(`torch.ops.sharkshark.*`), so that torch.export can trace a caller and
a saved program holds them as calls.

Each operator is declared once through `torch.library.Library` with its
schema, and registered with the C++ dispatcher under three keys: CUDA
(the kernel's launch), CPU (its plain version) and a fake implementation
(the output's shape and dtype, for tracing).  A call goes straight from
the dispatcher to the implementation of its tensors' device: there is
no Python layer around it.

The operators are inference-only: none registers a backward, and
`refuse_grad` makes the wrappers raise when autograd would have to
differentiate through one.
"""

from __future__ import annotations

import torch

_LIB = torch.library.Library("sharkshark", "DEF")


def define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Declare the operator `schema` (e.g. "f(Tensor x) -> Tensor") with
    its CPU, CUDA and fake implementations; returns the operator."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"sharkshark::{name}", fake, lib=_LIB)
    return getattr(torch.ops.sharkshark, name).default


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise if grad mode is on and one of `tensors` requires grad: the
    kernels' operators have no backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel's operator is inference-only (it has no backward); "
                           "differentiate through its plain version instead")
