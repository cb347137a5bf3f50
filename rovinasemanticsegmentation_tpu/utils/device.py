"""The accelerator a measurement runs on, and the refusal to run without one.

Every number the benchmark and the chip scripts print names the device
(``platform``, ``device_kind``, count) and the card's name and power limit
as ``nvidia-smi`` reports them: a card set below its maximum power runs
slower under load.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

import jax

SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def describe_devices() -> Dict[str, object]:
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu() -> Dict[str, object]:
    """The device description; raises unless JAX runs on a GPU."""
    info = describe_devices()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs a GPU, JAX found platform {info['platform']!r} "
            f"({info['kind']}); refusing to measure or check elsewhere"
        )
    return info


def parse_gpu_query(text: str) -> List[Tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit`` CSV -> [(name, limit)]."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def gpu_query_text() -> str:
    """The raw ``nvidia-smi`` name/power-limit lines (one per card)."""
    return subprocess.run(
        SMI_QUERY, capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()


def card_label() -> str:
    """'<name>, <power limit>' of the first card, to print beside numbers."""
    name, limit = parse_gpu_query(gpu_query_text())[0]
    return f"{name}, {limit}"
