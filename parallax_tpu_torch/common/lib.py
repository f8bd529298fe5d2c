"""The framework logger, device resolution and the resource-info
grammar.

``parallax_log`` is the counterpart of ``parallax_tpu.common.lib``'s
(same logger name, same format, same level variable), so one log
configuration covers both packages. ``HostInfo`` and
``parse_resource_info`` are copies of the JAX package's (reference
lib.py:121-150).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import List, Optional

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


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One line of the resource file: a host and its device indices.

    ``devices`` is None when the line omitted the list, meaning "every
    device on that host"."""

    hostname: str
    devices: Optional[tuple] = None


def _parse_resource_line(line: str) -> Optional[HostInfo]:
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    if ":" in line:
        host, devs = line.split(":", 1)
        host = host.strip()
        dev_ids = tuple(
            int(tok) for tok in devs.replace(",", " ").split() if tok)
        if not host:
            raise ValueError(f"bad resource line: {line!r}")
        return HostInfo(host, dev_ids if dev_ids else None)
    return HostInfo(line)


def parse_resource_info(resource_info: Optional[str]) -> List[HostInfo]:
    """Parse a resource spec: a path to a file or the literal spec text
    (newline- or semicolon-separated), one ``hostname[: dev,dev,...]``
    per entry."""
    if resource_info is None:
        return [HostInfo("localhost")]
    text = resource_info
    if os.path.exists(resource_info):
        with open(resource_info) as f:
            text = f.read()
    hosts: List[HostInfo] = []
    for line in text.replace(";", "\n").splitlines():
        parsed = _parse_resource_line(line)
        if parsed is not None:
            hosts.append(parsed)
    if not hosts:
        raise ValueError(f"no hosts found in resource_info: {resource_info!r}")
    seen = set()
    for h in hosts:
        if h.hostname in seen:
            raise ValueError(f"duplicate host {h.hostname!r} in resource_info")
        seen.add(h.hostname)
    return hosts
