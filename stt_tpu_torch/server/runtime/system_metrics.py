"""Process/system resource metrics for the /system endpoint.

Own copy of ``stt_tpu/server/runtime/system_metrics.py`` for the port,
which imports nothing of ``stt_tpu``. The JAX package's device section
(device kind/count and per-device memory from JAX) becomes a probe of the
cards through ``torch.cuda``, under the same switch
(``STT_ENABLE_TPU_METRICS``) and the same payload key (``"tpu"``, which
``tools/dashboard/monitor_dashboard.py`` reads): device count, platform
``"gpu"``, and per card its id, name (``kind``), the memory this process's
allocator holds (``bytes_in_use``) and the card's total (``bytes_limit``).

Parity with the reference collector (``stt_server/backend/utils/
system_metrics.py:21-125``): psutil process+system memory/CPU with a
``resource.getrusage`` fallback.
"""

from __future__ import annotations

import os
import resource
import sys
from typing import Any, Dict

try:
    import psutil
except ImportError:  # pragma: no cover - baked into the image
    psutil = None

_TPU_METRICS_ENV = "STT_ENABLE_TPU_METRICS"


def _process_metrics() -> Dict[str, Any]:
    if psutil is not None:
        proc = psutil.Process()
        with proc.oneshot():
            mem = proc.memory_info()
            return {
                "rss_bytes": int(mem.rss),
                "vms_bytes": int(mem.vms),
                "cpu_percent": float(proc.cpu_percent(interval=None)),
                "num_threads": int(proc.num_threads()),
            }
    usage = resource.getrusage(resource.RUSAGE_SELF)
    scale = 1024 if sys.platform != "darwin" else 1
    return {
        "rss_bytes": int(usage.ru_maxrss * scale),
        "vms_bytes": None,
        "cpu_percent": None,
        "num_threads": None,
    }


def _system_metrics() -> Dict[str, Any]:
    if psutil is None:
        return {}
    vm = psutil.virtual_memory()
    return {
        "memory_total_bytes": int(vm.total),
        "memory_available_bytes": int(vm.available),
        "memory_percent": float(vm.percent),
        "cpu_percent": float(psutil.cpu_percent(interval=None)),
        "cpu_count": psutil.cpu_count(),
        "load_avg": list(os.getloadavg()) if hasattr(os, "getloadavg") else None,
    }


def _tpu_metrics() -> Dict[str, Any]:
    """The cards, when ``STT_ENABLE_TPU_METRICS`` is on; platform ``"none"``
    and no device where CUDA is unavailable."""
    if os.getenv(_TPU_METRICS_ENV, "").strip().lower() not in {"1", "true", "yes", "on"}:
        return {}
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        payload: Dict[str, Any] = {
            "device_count": count,
            "platform": "gpu" if count else "none",
            "devices": [],
        }
        for idx in range(count):
            entry: Dict[str, Any] = {
                "id": idx,
                "kind": torch.cuda.get_device_name(idx),
            }
            try:
                entry["bytes_in_use"] = int(torch.cuda.memory_allocated(idx))
                entry["bytes_limit"] = int(torch.cuda.get_device_properties(idx).total_memory)
            except Exception:
                pass
            payload["devices"].append(entry)
        return payload
    except Exception:
        return {}


def collect_system_metrics() -> Dict[str, Any]:
    """Point-in-time resource snapshot for the /system endpoint."""
    payload: Dict[str, Any] = {
        "process": _process_metrics(),
        "system": _system_metrics(),
    }
    tpu = _tpu_metrics()
    if tpu:
        payload["tpu"] = tpu
    return payload


__all__ = ["collect_system_metrics"]
