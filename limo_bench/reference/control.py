"""The control of the output check: the reference computed one precision
below the configuration's float32, in bfloat16.

Every float32 tensor an operation returns is rounded to bfloat16 (the
inputs, the adopted state, every intermediate and every output), so the
frozen step computes as it would with bfloat16 storage between its
operations.  A check that this control passes cannot tell a change of
precision from a sound run."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


def _round(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
        return t.to(torch.bfloat16).to(torch.float32)
    return t


class Bfloat16(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.is_mutable:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    t.copy_(t.to(torch.bfloat16))
            return out
        return tree_map(_round, out)
