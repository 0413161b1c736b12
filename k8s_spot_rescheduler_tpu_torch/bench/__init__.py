"""Benchmark harnesses: solution-quality oracle, streaming replay,
chain-depth demand and the device-only protocol; ``python -m
k8s_spot_rescheduler_tpu_torch.bench`` drives them (``__main__.py``)."""

from k8s_spot_rescheduler_tpu_torch.bench.quality import (
    drain_to_exhaustion,
    ilp_max_drains,
)
from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay

__all__ = ["drain_to_exhaustion", "ilp_max_drains", "run_replay"]
