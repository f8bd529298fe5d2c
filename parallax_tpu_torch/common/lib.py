"""The framework logger, device resolution and the resource-info
grammar.

``parallax_log`` is the counterpart of ``parallax_tpu.common.lib``'s
(same logger name, same format, same level variable), so one log
configuration covers both packages; ``configure_logging`` and
``JsonLogFormatter`` are copies of the JAX package's. ``HostInfo``,
``parse_resource_info`` and ``serialize_resource_info`` /
``deserialize_resource_info`` are copies of the JAX package's
(reference lib.py:121-176). ``rank_layout`` is the port's own: one rank
per (host, chip), the PyTorch idiom of one process per card.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import json
import logging
import socket
import os
import sys
from typing import List, Optional, Sequence, Tuple

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


class JsonLogFormatter(logging.Formatter):
    """One JSON object per log line (machine-scraped runs): ts / level /
    logger / msg, plus the traceback under "exc" when present."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure_logging(level=None, json_format: bool = False) -> None:
    """Re-configure the PARALLAX logger at runtime.

    The import-time level comes from env PARALLAX_LOG_LEVEL — useless to
    a program that builds its ``ParallaxConfig`` after import.
    ``Config(log_level=..., log_json=...)`` routes here at session
    construction. No-args is a no-op (the env-var behavior stands); both
    knobs only touch the PARALLAX logger, never the root logger. The
    logger is process-global, so the change outlives the configuring
    session — deliberate: logging is a per-process concern (concurrent
    sessions share the stream), and a close-time restore would flap the
    format mid-run for whichever session remains.
    """
    if level is not None:
        parallax_log.setLevel(
            level if isinstance(level, int) else str(level).upper())
    if json_format:
        fmt = JsonLogFormatter()
        for handler in parallax_log.handlers:
            handler.setFormatter(fmt)


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

    def to_json(self):
        return {"hostname": self.hostname,
                "devices": list(self.devices) if self.devices else None}

    @staticmethod
    def from_json(d) -> "HostInfo":
        devs = d.get("devices")
        return HostInfo(d["hostname"], tuple(devs) if devs else None)


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


def serialize_resource_info(hosts: Sequence[HostInfo]) -> str:
    """The env-var form of a parsed resource spec (JSON)."""
    return json.dumps([h.to_json() for h in hosts])


def deserialize_resource_info(serialized: str) -> List[HostInfo]:
    return [HostInfo.from_json(d) for d in json.loads(serialized)]


def is_local_host(hostname: str) -> bool:
    """True for ``localhost``, a loopback address (all of 127/8) and
    this machine's own host name. Nothing is resolved."""
    if hostname == "localhost":
        return True
    try:
        if ipaddress.ip_address(hostname).is_loopback:
            return True
    except ValueError:
        pass
    return hostname == socket.gethostname()


def rank_layout(hosts: Sequence[HostInfo],
                device_type: str = "cuda") -> List[Tuple[str, int]]:
    """``[(hostname, chip)]`` by rank: one rank per (host, chip), hosts
    in the spec's order, chips in their listed order. A host listed
    without chips takes every visible card (one rank on the CPU).
    Ranks on hosts other than this one need a remote launcher, which is
    not ported: such a spec raises ``NotImplementedError``."""
    remote = [h.hostname for h in hosts if not is_local_host(h.hostname)]
    if remote:
        raise NotImplementedError(
            f"resource_info names remote hosts {remote}: the ssh launcher "
            f"and elastic restart are not ported; every rank must run on "
            f"this host")
    out = []
    for h in hosts:
        chips = h.devices
        if chips is None:
            n = torch.cuda.device_count() if device_type == "cuda" else 1
            chips = tuple(range(max(n, 1)))
        out.extend((h.hostname, int(c)) for c in chips)
    return out
