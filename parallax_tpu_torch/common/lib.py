"""The framework logger and device resolution.

``parallax_log`` is the counterpart of ``parallax_tpu.common.lib``'s
(same logger name, same format, same level variable), so one log
configuration covers both packages.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from parallax_tpu_torch.common import consts

parallax_log = logging.getLogger("PARALLAX")
if not parallax_log.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
    parallax_log.addHandler(_handler)
parallax_log.setLevel(os.environ.get(consts.PARALLAX_LOG_LEVEL, "INFO"))


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine
    without one: the entry points run on the card unless the caller
    asks for the CPU (``device="cpu"``), and never drop to the CPU on
    their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev
