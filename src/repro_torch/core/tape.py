"""QTape — the per-call quantization context model code writes against.

A layer function receives a tape scoped to its own scale and sink slices
and calls ``tape.act(name, x)`` after every weighted sum / nonlinearity
and ``tape.weight(name, w)`` when a stored parameter enters a
multiplication.  The tape records forward overflow statistics in
``tape.stats``; backward statistics arrive as the gradients of the sinks
(see :mod:`repro_torch.core.quant`), so a train step differentiates the
loss with respect to the parameters and the sinks together.  With no
sinks (serving) the sites still round both ways and simply have no sink
to report to.

This is ``repro.core.tape.QTape``.  Where the reference rounds a value
once for its result and once more for its statistics, this tape rounds
once and takes both from the same pass — the same numbers, one pass
instead of two.

Group naming convention (the paper's per-layer groups):
  ``a:<site>`` activation scale, ``g:<site>`` gradient scale,
  ``w:<name>`` weight use-time scale, ``p:<name>`` parameter-storage scale.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .policy import PrecisionPolicy
from .quant import fixed_round, q_stats, qbound_site, ste_site

Tensor = torch.Tensor

# Group-prefix → tensor-class names, the paper's §3 breakdown plus the
# optimizer-side groups of the train state ("pg:" gradient of a
# parameter, "pm:" momentum).
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
    def __init__(self, policy: PrecisionPolicy, scales: Dict[str, Tensor],
                 sinks: Optional[Dict[str, Tensor]] = None):
        self.policy = policy
        self.scales = scales
        self.sinks = sinks if sinks is not None else {}
        self.stats: Dict[str, Tensor] = {}

    def _exp(self, group: str):
        return self.scales.get(group, 0.0)

    def _record(self, group: str, stats: Tensor) -> None:
        if group in self.stats:
            self.stats[group] = self.stats[group] + stats
        else:
            self.stats[group] = stats

    @property
    def _records(self) -> bool:
        return self.policy.dynamic or self.policy.observing

    def _bound(self, name: str, x: Tensor, fmt, record: bool) -> Tensor:
        """A ``qbound`` site: value and cotangent rounded in ``fmt``."""
        want = self._records and record
        y, stats = qbound_site(x, fmt, fmt, self._exp(f"a:{name}"),
                               self._exp(f"g:{name}"),
                               self.sinks.get(f"g:{name}"), want_stats=want)
        if want:
            self._record(f"a:{name}", stats)
        return y

    def act(self, name: str, x: Tensor) -> Tensor:
        """Activation site: forward value and backward cotangent rounded at
        the computation width."""
        if not self.policy.enabled:
            return x
        return self._bound(name, x, self.policy.comp_format(), True)

    def weight(self, name: str, w: Tensor) -> Tensor:
        """Weight use-time site: the stored parameter re-quantized to the
        computation width.  Straight-through backward — the weight
        gradient is quantized once, in the train step (``pg:`` groups)."""
        if not self.policy.enabled:
            return w
        y, stats = ste_site(w, self.policy.comp_format(),
                            self._exp(f"w:{name}"), want_stats=self._records)
        if self._records:
            self._record(f"w:{name}", stats)
        return y

    def state(self, name: str, x: Tensor, record: bool = True) -> Tensor:
        """Recurrent-state site: quantized at the *update* width (paper §6 —
        states, like parameters, accumulate many small contributions).
        ``record=False`` leaves the statistics to
        :meth:`record_state_stats`, called once on the stacked values."""
        if not self.policy.enabled:
            return x
        return self._bound(name, x, self.policy.update_format(), record)

    def record_state_stats(self, name: str, x: Tensor) -> None:
        if self.policy.enabled and self._records:
            self._record(f"a:{name}", q_stats(x, self.policy.update_format(),
                                              self._exp(f"a:{name}")))

    def dot(self, name: str, x: Tensor, w: Tensor, *,
            transpose_b: bool = False) -> Tensor:
        """Quantized matmul: weight re-quantized to comp width, f32 accumulate.

        ``w`` is ``[d_in, d_out]`` as in ``x @ w``, or ``[d_out, d_in]``
        under ``transpose_b`` (the tied-head layout).  Under DFXP with
        ``policy.fused_matmul`` the whole site — weight rounding, matmul,
        dgrad, wgrad — runs through the hand-written quantized matmul K2
        (:func:`repro_torch.kernels.dispatch.tape_dot`), and the weight's
        statistics come from one rounding pass of their own.  Otherwise the
        product is ``torch.matmul`` in full float32 (TF32 is off, see
        :mod:`repro_torch`), as the reference leaves it to XLA.
        """
        pol = self.policy
        if pol.dynamic and pol.fused_matmul:
            from repro_torch.kernels.dispatch import tape_dot
            fmt = pol.comp_format()
            e = self._exp(f"w:{name}")
            y = tape_dot(x, w, e, width=fmt.width, transpose_b=transpose_b)
            with torch.no_grad():
                _, (ovf, ovfh) = fixed_round(w, fmt.width, e)
            n = torch.tensor(float(w.numel()), dtype=torch.float32,
                             device=w.device)
            self._record(f"w:{name}", torch.stack([ovf, ovfh, n]))
            return y
        wq = self.weight(name, w).to(x.dtype)
        if transpose_b:
            return torch.matmul(x, wq.transpose(-1, -2))
        return torch.matmul(x, wq)

