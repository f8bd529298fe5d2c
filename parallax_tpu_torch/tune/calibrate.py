"""Cost-model calibration: close the predicted-vs-measured loop
(``parallax_tpu/tune/calibrate.py``, same file format: a file either
package writes, the other loads).

The roofline (tune/costmodel.py) prices plans from nominal constants. A
profiled window (obs/xprof.py) measures where the step's device time
went: collective self-time against everything else. This module compares
the two per term, stamps a ``predicted_over_measured`` ratio for each,
and persists the result as a small JSON file
(``Config.calibration_path``) that the cost model loads on the next
search in place of the nominal exchange rates.

Two terms, matching the model (``step ~= max(compute, HBM) + wire``):

* ``on_chip`` — the ``max(compute_s, hbm_s)`` roofline term against the
  measured non-collective device self-time per step per device
  (compute, copies, host-to-device and device-to-host transfers).
  Compute and HBM overlap on the card, so a trace cannot split them.
* ``wire`` — the summed interconnect terms against the measured
  collective self-time per step per device.

A ratio > 1 means the model over-predicts that term; at predict time
each term is divided by its ratio. The ratios are honest to the device
they were measured on, which the file's ``basis`` and ``meta`` name: a
file made on the CPU encodes CPU rates and is wrong for the card.

A missing, corrupt or foreign file loads as None, loudly, and the model
keeps its nominal constants.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from parallax_tpu_torch.common.lib import parallax_log

FORMAT = "parallax-calibration"
VERSION = 1

# the calibrated terms, matching the roofline's structure
TERMS = ("on_chip", "wire")

# guard rails: a ratio outside this band means the profile and the
# prediction disagree by >10^6 — a unit bug or a broken capture, and
# applying it would corrupt every ranking. The band is wide on purpose:
# the CPU measures some 10^4-10^5 times slower than the nominal card
# constants predict (that gap is the calibration signal there).
_MIN_RATIO, _MAX_RATIO = 1e-6, 1e6


def predicted_terms_from_cost(terms: Dict[str, float]
                              ) -> Dict[str, float]:
    """Collapse a ``PlanCost.terms`` breakdown (seconds) onto the two
    calibrated terms: ``on_chip = max(compute, hbm)`` (the roofline
    takes the binding ceiling — on pp>1 plans compute/hbm already
    carry the bubble scale, so the bubble calibrates with on_chip)
    and ``wire`` = every interconnect term, including the pp>1 plans'
    inter-stage ppermute stream ``wire_pp_s`` (the hidden share under
    sync=False stays excluded — it was never predicted to cost wall
    time)."""
    on_chip = max(float(terms.get("compute_s", 0.0)),
                  float(terms.get("hbm_s", 0.0)))
    wire = (float(terms.get("wire_dense_s", 0.0))
            + float(terms.get("wire_zero_shard_s", 0.0))
            + float(terms.get("wire_table_s", 0.0))
            + float(terms.get("wire_pp_s", 0.0))
            - float(terms.get("wire_hidden_s", 0.0)))
    return {"on_chip": on_chip, "wire": max(0.0, wire)}


def measured_terms_from_attribution(attrib: Dict[str, Any],
                                    num_devices: int
                                    ) -> Optional[Dict[str, float]]:
    """Measured per-step per-device seconds for the two terms, from an
    ``obs/xprof`` attribution dict. Self-times in the attribution are
    device-seconds summed over concurrent devices, so dividing by the
    device count and the captured step count yields the per-device
    per-step wall contribution the model's terms predict. None when
    the capture is unusable (no steps, no events)."""
    steps = attrib.get("steps")
    cats = attrib.get("by_category") or {}
    if not steps or not cats:
        return None
    denom = float(steps) * max(1, int(num_devices)) * 1e3  # ms -> s
    coll = float((cats.get("collective") or {}).get("self_ms", 0.0))
    on_chip = sum(float(v.get("self_ms", 0.0))
                  for k, v in cats.items() if k != "collective")
    return {"on_chip": on_chip / denom, "wire": coll / denom}


def build_record(predicted_s: Dict[str, float],
                 measured_s: Dict[str, float],
                 basis: str = "nominal",
                 meta: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """One calibration record from matching per-term seconds.
    Terms whose measured side is zero (a capture with no collectives:
    single device, or the window missed them) are recorded with a
    null ratio and skipped at load — partial calibration beats
    none."""
    terms: Dict[str, Any] = {}
    for t in TERMS:
        p = float(predicted_s.get(t, 0.0))
        m = float(measured_s.get(t, 0.0))
        ratio = (p / m) if (p > 0 and m > 0) else None
        terms[t] = {
            "predicted_s": p, "measured_s": m,
            "predicted_over_measured": (round(ratio, 6)
                                        if ratio is not None
                                        else None),
        }
    return {
        "format": FORMAT, "version": VERSION,
        "created_unix": time.time(),
        "basis": basis,
        "terms": terms,
        "meta": dict(meta or {}),
    }


def ratios(record: Optional[Dict[str, Any]]
           ) -> Optional[Dict[str, float]]:
    """The usable per-term ratios of a loaded record — only terms
    with a positive, sane ratio survive; None when nothing does (the
    nominal fallback)."""
    if not isinstance(record, dict):
        return None
    out: Dict[str, float] = {}
    for t, entry in (record.get("terms") or {}).items():
        if t not in TERMS or not isinstance(entry, dict):
            continue
        r = entry.get("predicted_over_measured")
        if isinstance(r, (int, float)) \
                and _MIN_RATIO <= float(r) <= _MAX_RATIO:
            out[t] = float(r)
    return out or None


def save(path: str, record: Dict[str, Any]) -> str:
    """Atomic write (temp + rename): a crash mid-save must leave the
    previous calibration readable, never a torn file the next search
    chokes on."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    parallax_log.info("calibration saved to %s (%s)", path,
                      {t: (record["terms"].get(t) or {}).get(
                          "predicted_over_measured")
                       for t in TERMS})
    return path


def load(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Load + validate a calibration file; None (LOUD log, nominal
    fallback) on missing/corrupt/foreign-format content — a bad file
    must cost the calibration, never the search."""
    if not path:
        return None
    try:
        with open(path) as f:
            record = json.load(f)
    except FileNotFoundError:
        parallax_log.info(
            "no calibration file at %s; cost model keeps nominal "
            "constants", path)
        return None
    except (OSError, ValueError) as e:
        parallax_log.warning(
            "calibration file %s unreadable (%s); cost model keeps "
            "nominal constants", path, e)
        return None
    if not isinstance(record, dict) \
            or record.get("format") != FORMAT \
            or not isinstance(record.get("terms"), dict):
        parallax_log.warning(
            "calibration file %s is not a %s record; cost model "
            "keeps nominal constants", path, FORMAT)
        return None
    if ratios(record) is None:
        parallax_log.warning(
            "calibration file %s carries no usable term ratio; cost "
            "model keeps nominal constants", path)
        return None
    return record


__all__ = ["TERMS", "FORMAT", "build_record", "load", "ratios",
           "save", "predicted_terms_from_cost",
           "measured_terms_from_attribution"]
