"""QTape — the per-call quantization context model code writes against.

A layer function receives a tape scoped to its own scale slices and calls
``tape.act(name, x)`` after every weighted sum / nonlinearity and
``tape.weight(name, w)`` when a stored parameter enters a multiplication.
The tape records forward overflow statistics in ``tape.stats``; the
stage loop stacks them per layer.

This is the forward half of ``repro.core.tape.QTape``: no sinks and no
backward statistics, since nothing here takes a gradient.  Where the
reference rounds a value once for its result and once more for its
statistics, this tape rounds once and takes both from the same pass —
the same numbers, one pass over the weight instead of two.

Group naming convention (the paper's per-layer groups):
  ``a:<site>`` activation scale, ``w:<name>`` weight use-time scale.
"""
from __future__ import annotations

from typing import Dict

import torch

from .formats import DynamicFixedPoint
from .policy import PrecisionPolicy
from .quant import fixed_round, q_stats, qbound, ste_quant

Tensor = torch.Tensor

# Group-prefix → tensor-class names, the paper's §3 breakdown plus the
# optimizer-side groups of the reference's train state.
_TENSOR_CLASSES = {
    "a": "activation",
    "g": "gradient",
    "w": "weight",
    "p": "param",
    "pg": "param_grad",
    "pm": "momentum",
}


def tensor_class(group: str) -> str:
    """Tensor class of a tape group name (``"a:mlp_out"`` → ``"activation"``)."""
    prefix = group.split(":", 1)[0]
    return _TENSOR_CLASSES.get(prefix, prefix)


class QTape:
    def __init__(self, policy: PrecisionPolicy, scales: Dict[str, Tensor]):
        self.policy = policy
        self.scales = scales
        self.stats: Dict[str, Tensor] = {}

    def _exp(self, group: str):
        return self.scales.get(group, 0.0)

    def _record(self, group: str, stats: Tensor) -> None:
        if group in self.stats:
            self.stats[group] = self.stats[group] + stats
        else:
            self.stats[group] = stats

    def _site(self, group: str, x: Tensor, quantize) -> Tensor:
        """Round ``x`` at the computation width; record its statistics."""
        pol = self.policy
        fmt = pol.comp_format()
        e = self._exp(group)
        if isinstance(fmt, DynamicFixedPoint):
            y, (ovf, ovfh) = fixed_round(x, fmt.width, e)
            n = torch.tensor(float(x.numel()), dtype=torch.float32,
                             device=x.device)
            self._record(group, torch.stack([ovf, ovfh, n]))
            return y
        y = quantize(x, fmt, e)
        if pol.observing:
            self._record(group, q_stats(x, fmt, e))
        return y

    def act(self, name: str, x: Tensor) -> Tensor:
        """Activation site: value rounded at the computation width."""
        if not self.policy.enabled:
            return x
        return self._site(f"a:{name}", x, qbound)

    def weight(self, name: str, w: Tensor) -> Tensor:
        """Weight use-time site: the stored parameter re-quantized to the
        computation width."""
        if not self.policy.enabled:
            return w
        return self._site(f"w:{name}", w, ste_quant)

    def dot(self, name: str, x: Tensor, w: Tensor) -> Tensor:
        """Quantized matmul: weight re-quantized to comp width, f32 accumulate.

        ``w`` is ``[d_in, d_out]`` as in ``x @ w``.  The product is
        ``torch.matmul`` in full float32 (TF32 is off, see
        :mod:`repro_torch`), as the reference leaves it to XLA; the fused
        DFXP matmul kernel (K2) is not ported yet.
        """
        return torch.matmul(x, self.weight(name, w).to(x.dtype))
