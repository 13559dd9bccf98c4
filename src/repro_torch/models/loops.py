"""The per-token loop of the recurrent mixers (the RG-LRU prefill and the
sLSTM), with one hook for a counting mode.

:func:`token_loop` runs every step.  A ``TorchDispatchMode`` on the active
mode stack that has a ``run_token_loop`` attribute may run the loop
instead (:class:`repro_torch.roofline.op_stats.OpStats` with
``sample_loops=True`` counts it from a few steps).  The hook is found
through the dispatch-mode stack, which autograd carries into the threads
it runs a backward in, so a recomputation under ``torch.utils.checkpoint``
finds the same hook as the forward did.

Each input is split into its steps once (``x.unbind(1)``), whose backward
is one ``stack`` of the steps' gradients: a training step moves O(S)
bytes.  Reading step t as ``x[:, t]`` would give each step's backward a
zero (B, S, ...) gradient of its own, O(S^2) bytes in all.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

Step = Callable[[Tuple, Tuple, Tuple], Tuple[Tuple, torch.Tensor]]


def _hook():
    """The innermost active mode's ``run_token_loop`` (None: run every
    step)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "run_token_loop"):
            return mode.run_token_loop
    return None


def token_loop(step: Step, carry: Sequence[torch.Tensor],
               xs: Sequence[torch.Tensor], n: int,
               consts: Sequence[torch.Tensor] = ()):
    """``carry, y_t = step(carry, tuple(x[:, t] for x in xs), consts)`` for
    t < n; returns (carry, the y_t stacked along dim 1)."""
    carry, xs, consts = tuple(carry), tuple(xs), tuple(consts)
    hook = _hook()
    if hook is not None:
        return hook(step, carry, xs, n, consts)
    return run_steps(step, carry, [x.unbind(1) for x in xs], n, consts)


def run_steps(step: Step, carry: Tuple, steps: Sequence[Sequence[torch.Tensor]],
              n: int, consts: Tuple):
    """The first ``n`` steps of ``step`` over ``steps`` (each input's
    per-step tensors); returns (carry, the y_t stacked along dim 1)."""
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(s[t] for s in steps), consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)
