"""Telemetry: metric dicts -> one host transfer per record + structured logs.

Counterpart of ``blf_tpu/utils/telemetry.py``; everything of it is ported. A
dict of device scalars/arrays is flattened into ONE tensor, moved device ->
host once per record, and fanned back out to named channels on the host.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import sys
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["merge_metrics", "TelemetryStream", "get_logger"]

_LOGGER_NAME = "blf_tpu_torch"


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    """Structured logger with the ``[name.LEVEL] message`` format."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(name)s.%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def merge_metrics(metrics: Dict[str, Any]):
    """Flatten a dict of scalars/tensors into one 1-D tensor plus a layout
    ``[(name, shape), ...]`` for host-side unpacking. The merged tensor lies
    where the first tensor value lies (the CPU if there is none)."""
    device = next((v.device for v in metrics.values()
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    values = [torch.as_tensor(v, device=device) if not isinstance(v, torch.Tensor)
              else v.detach() for v in metrics.values()]
    layout = [(name, tuple(v.shape)) for name, v in zip(metrics, values)]
    dtype = functools.reduce(torch.promote_types, (v.dtype for v in values),
                             torch.float32)
    merged = torch.cat([v.reshape(-1).to(dtype) for v in values])
    return merged, layout


class TelemetryStream:
    """Per-record telemetry channel: one device->host transfer, named
    fan-out; sinks are JSONL streams/files."""

    def __init__(self, sink=None, name: str = "telemetry"):
        self._sink = sink if sink is not None else sys.stdout
        self._name = name
        self._history: List[Dict[str, Any]] = []

    def publish(self, metrics: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """Merge -> single transfer -> unpack -> emit one JSONL record."""
        merged, layout = merge_metrics(metrics)
        host = merged.cpu().numpy()        # the one device->host transfer
        record: Dict[str, Any] = {"stream": self._name, "time": time.time()}
        if step is not None:
            record["step"] = step
        k = 0
        for name, shape in layout:
            size = math.prod(shape) if shape else 1
            chunk = host[k: k + size]
            record[name] = (
                float(chunk[0]) if not shape else chunk.reshape(shape).tolist())
            k += size
        self._history.append(record)
        print(json.dumps(record), file=self._sink)
        return record

    @property
    def history(self) -> List[Dict[str, Any]]:
        return self._history
