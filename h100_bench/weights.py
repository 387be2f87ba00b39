"""The benchmark's weights, drawn on the device from ``--seed``.

One ``torch.Generator`` on the device makes two large draws, the normal
numbers of every leaf and the uniform ones, and each leaf is a slice of
them, scaled as the reference's ``param_spec`` says. The same seed and
device give the same tensors, so the harness can draw them again for the
reference once the program's state is gone. The program gets them by
parameter name (:func:`load`), the reference as they are.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

UNIFORM = ("a_log", "dt_bias")


def make(spec, seed: int, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every leaf of ``spec`` (the reference's
    ``param_spec``), in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [(name, tuple(shape), how, math.prod(shape))
             for name, shape, how in spec]
    n_uniform = sum(n for _, _, how, n in sizes if how[0] in UNIFORM)
    normal = torch.randn(sum(n for *_, n in sizes) - n_uniform,
                         generator=gen, device=device, dtype=torch.float32)
    uniform = torch.rand(n_uniform, generator=gen, device=device,
                         dtype=torch.float32)
    out, zi, ui = {}, 0, 0
    for name, shape, how, n in sizes:
        if how[0] in UNIFORM:
            t, ui = uniform[ui:ui + n].view(shape), ui + n
            if how[0] == "a_log":        # A = exp(a_log) uniform in [1, 16]
                t.mul_(15.0).add_(1.0).log_()
            else:                        # Δt log-uniform in [1e-3, 1e-1]
                lo, hi = math.log(1e-3), math.log(1e-1)
                t.mul_(hi - lo).add_(lo).exp_().expm1_().log_()
        else:
            t, zi = normal[zi:zi + n].view(shape), zi + n
            if how[0] == "normal":
                t.mul_(how[1])
            elif how[0] == "gain":
                t.mul_(0.1).add_(1.0)
            elif how[0] == "bias":
                t.mul_(0.02)
            else:
                raise ValueError(f"{name}: unknown draw {how!r}")
        out[name] = t if dtype == torch.float32 else t.to(dtype)
    return out


@torch.no_grad()
def load(params: Mapping[str, torch.Tensor],
         weights: Mapping[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's ``params`` ({name: tensor}) by
    name; a name or shape that differs raises."""
    missing = sorted(set(weights) - set(params))
    extra = sorted(set(params) - set(weights))
    if missing or extra:
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's: missing {missing[:5]}, unexpected "
                         f"{extra[:5]}")
    for name, dst in params.items():
        src = weights[name]
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"{name}: the program holds {tuple(dst.shape)}, "
                             f"the benchmark draws {tuple(src.shape)}")
        dst.copy_(src)
