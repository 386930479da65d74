"""Numeric-health timeline: §5 controller telemetry as JSONL records.

The paper's dynamic fixed-point scheme is a runtime feedback loop — per
group, the controller watches overflow rates and moves the shared
exponent ×2/÷2 every ``update_interval`` updates.  End-of-run totals
(``overflow_summary``) say whether it *converged*; this module records
the loop itself as a time series:

* **serve-side** — a batched snapshot of the packed KV pool
  (``repro_torch.serve.kv_pool.numerics_snapshot``: per-layer/per-slot K
  and V exponents plus cumulative overflow counters, fetched to the host
  once per sample) and :func:`serve_records` diffs it against the
  previous sample into per-slot records carrying exponent values,
  overflow/underflow rates, and the controller's up/down moves;
* **train-side** — ``train/step.py``'s ``numerics_tap`` returns the old
  and new exponents and the pre-reset §5 accumulators of the step;
  :func:`train_records` aggregates them per tensor class (activation /
  gradient / weight / param...) via
  :func:`repro_torch.core.tape.tensor_class`.

Both flow into a :class:`NumericsLog` — an append-only JSONL sink (one
JSON object per line) that is trivially greppable and loads into any
dataframe tool.  Everything here is stdlib-only and host-side (the
port's own copy of ``repro.obs.numerics``, so the two packages write the
same records from the same inputs); array inputs are accepted via
duck-typed ``.tolist()``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


def _tolist(x):
    return x.tolist() if hasattr(x, "tolist") else x


class NumericsLog:
    """Append-only JSONL sink for numeric-health records.

    With a ``path``, every :meth:`record` appends one line to the file;
    without one, records accumulate in :attr:`records` (tests, and the
    CLI's end-of-run summary read them back either way).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        self._f = open(path, "w") if path else None

    def record(self, rec: dict) -> None:
        self.records.append(rec)
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def tail(self, n: int = 50) -> List[dict]:
        """Last ``n`` records (the diagnostic-bundle excerpt)."""
        return self.records[-n:] if n else []

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_records(snapshot: dict, prev: Optional[dict], *, step: int,
                  t: float, slot_uids: Optional[Dict[int, int]] = None,
                  ) -> List[dict]:
    """Diff two KV-pool numerics snapshots into per-slot JSONL records.

    ``snapshot``/``prev`` are host-fetched ``kv_pool.numerics_snapshot``
    dicts: ``{entry_key: {"k_e"/"v_e"/"ovf"/"half"/"tot": [n_layers,
    n_slots]}}``.  One record per (entry, slot) carrying per-layer lists:

    * ``k_e``/``v_e`` — the current shared exponents (log2 steps);
    * ``ovf_rate``/``half_rate`` — cumulative §5 overflow / would-overflow-
      at-half-range rates of the slot's appends;
    * ``k_move``/``v_move`` — the controller's decision since the last
      sample per layer: +1 scale-up (exponent grew, range extended after
      overflows), −1 scale-down (precision reclaimed after a quiet
      window), 0 hold.  ``None`` on the first sample.

    Only slots present in ``slot_uids`` (occupied) are emitted when it is
    given; pass ``None`` to emit every slot.
    """
    out: List[dict] = []
    for ekey, cur in snapshot.items():
        k_e, v_e = _tolist(cur["k_e"]), _tolist(cur["v_e"])
        ovf, half, tot = (_tolist(cur["ovf"]), _tolist(cur["half"]),
                          _tolist(cur["tot"]))
        pk = pv = None
        if prev is not None and ekey in prev:
            pk, pv = _tolist(prev[ekey]["k_e"]), _tolist(prev[ekey]["v_e"])
        n_layers = len(k_e)
        n_slots = len(k_e[0]) if n_layers else 0
        slots = range(n_slots) if slot_uids is None else sorted(slot_uids)
        for b in slots:
            if b >= n_slots:
                continue
            rec = {
                "kind": "serve", "t": t, "step": step, "entry": ekey,
                "slot": b,
                "uid": slot_uids.get(b) if slot_uids is not None else None,
                "k_e": [k_e[L][b] for L in range(n_layers)],
                "v_e": [v_e[L][b] for L in range(n_layers)],
                "ovf_rate": [ovf[L][b] / max(tot[L][b], 1.0)
                             for L in range(n_layers)],
                "half_rate": [half[L][b] / max(tot[L][b], 1.0)
                              for L in range(n_layers)],
                "k_move": None if pk is None else
                [_sign(k_e[L][b] - pk[L][b]) for L in range(n_layers)],
                "v_move": None if pv is None else
                [_sign(v_e[L][b] - pv[L][b]) for L in range(n_layers)],
            }
            out.append(rec)
    return out


def train_records(prev_exps: dict, exps: dict, acc: dict, *, step: int,
                  t: float) -> List[dict]:
    """Aggregate one controller application into per-tensor-class records.

    ``prev_exps``/``exps``: group → exponent (scalar, host-fetched) before
    and after ``controller_step``; ``acc``: group → ``(ovf, ovf_half,
    total)`` — the §5 window accumulators the decision was made FROM
    (i.e. captured before the post-apply reset).  One record per tensor
    class (:func:`repro_torch.core.tape.tensor_class` of the group name).
    """
    from repro_torch.core.tape import tensor_class

    by_cls: Dict[str, dict] = {}
    for g, e_new in exps.items():
        cls = tensor_class(g)
        d = by_cls.setdefault(cls, {"exp": [], "up": 0, "down": 0,
                                    "ovf": 0.0, "half": 0.0, "tot": 0.0})
        new_vals = _flat(e_new)
        old_vals = _flat(prev_exps.get(g, e_new))
        for en, eo in zip(new_vals, old_vals):
            d["exp"].append(en)
            mv = _sign(en - eo)
            if mv > 0:
                d["up"] += 1
            elif mv < 0:
                d["down"] += 1
        a = acc.get(g) if acc else None
        if a is not None:
            # shape exps.shape + (3,): sum the (ovf, half, tot) triples
            flat = _flat(a)
            d["ovf"] += sum(flat[0::3])
            d["half"] += sum(flat[1::3])
            d["tot"] += sum(flat[2::3])
    out = []
    for cls in sorted(by_cls):
        d = by_cls[cls]
        tot = max(d["tot"], 1.0)
        out.append({
            "kind": "train", "t": t, "step": step, "class": cls,
            "n_groups": len(d["exp"]),
            "exp_mean": sum(d["exp"]) / len(d["exp"]),
            "exp_min": min(d["exp"]), "exp_max": max(d["exp"]),
            "ovf_rate": d["ovf"] / tot, "half_rate": d["half"] / tot,
            "moves_up": d["up"], "moves_down": d["down"],
        })
    return out


def count_moves(records: List[dict]) -> int:
    """Total §5 controller exponent moves across a record list (CI check)."""
    n = 0
    for r in records:
        if r.get("kind") == "train":
            n += int(r.get("moves_up", 0)) + int(r.get("moves_down", 0))
        else:
            for key in ("k_move", "v_move"):
                mv = r.get(key)
                if mv:
                    n += sum(1 for m in mv if m)
    return n


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _sign(d: float) -> int:
    return (d > 0) - (d < 0)


def _flat(x) -> List[float]:
    """Flatten a scalar / nested-list / array value to a float list."""
    x = _tolist(x)
    if not isinstance(x, list):
        return [float(x)]
    out: List[float] = []
    for v in x:
        out.extend(_flat(v))
    return out


__all__ = ["NumericsLog", "serve_records", "train_records", "count_moves",
           "read_jsonl"]
