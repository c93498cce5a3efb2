"""One worker process per GPU.

A JAX process reserves most of a card's memory when it first uses the
card, so two processes cannot share one.  Worker pools therefore give
each worker its own card through ``CUDA_VISIBLE_DEVICES``, set in the
worker before JAX is imported.  This module imports neither JAX nor any
module that does, so a pool initializer can live here.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional


def visible_gpus() -> List[str]:
    """GPU ids this process may hand out, without initializing JAX.

    ``CUDA_VISIBLE_DEVICES`` when it is set; otherwise the indices
    ``nvidia-smi`` lists (none on a host without it or without cards).
    """
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def assign_gpus(num_workers: int,
                platform: Optional[str] = None) -> List[Optional[str]]:
    """The card of each of ``num_workers`` workers (None: no pinning).

    Workers on the CPU backend (``platform`` or ``JAX_PLATFORMS`` says
    "cpu", or the host has no GPU) are not pinned.  On a GPU host each
    worker gets a card of its own, and more workers than cards is an
    error.
    """
    wants_cpu = "cpu" in (platform or "", os.environ.get("JAX_PLATFORMS", ""))
    gpus = [] if wants_cpu else visible_gpus()
    if not gpus:
        return [None] * num_workers
    if num_workers > len(gpus):
        raise ValueError(
            f"num_workers={num_workers} exceeds the {len(gpus)} GPU(s) "
            f"visible ({','.join(gpus)}): each worker needs a card of its "
            "own, because a JAX process reserves most of a card's memory")
    return gpus[:num_workers]


def pin_worker_gpu(card_queue) -> None:
    """Pool initializer: take one card id from the queue and pin to it."""
    card = card_queue.get()
    if card is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = card
