"""Planner sidecar: the JSON/HTTP face of the multi-tenant service.

The port of the JAX package's ``sidecar/server.py``. An existing
controller (the Go reference among them) can delegate only the per-tick
drain *plan* to the card while keeping its own eviction path:

    POST /v1/plan
      {"nodes": [<k8s Node>...], "pods": [<k8s Pod>...],
       "pdbs": [<k8s PDB>...],
       "pvcs": [<k8s PVC>...], "pvs": [<k8s PV>...]}   # optional
    → {"found": true, "node": "od-17", "pods": [...],
       "assignments": {"ns/pod": "spot-3", ...},
       "nCandidates": 2500, "nFeasible": 856, "solveMs": 1.2,
       "batchLanes": 24, "batchTenants": 3}

    GET /healthz → {"ok": true, "solver": "torch", "batch_program": ...,
                    "queue_depth": 0, "bucket_occupancy": {...}, ...}

``PlannerSidecar`` IS the planner service's HTTP server
(``service/server.ServiceServer``) with the historical constructor
surface (``busy_timeout_s`` maps onto the queue's bounded wait): /v1/plan
requests decode, pack and ride the same batching queue as the binary
``/v2/plan`` tenants, so JSON callers co-batch with wire-protocol agents
on kernels B1t/B2t. A request that cannot be batched within
``busy_timeout_s`` gets 503 with ``Retry-After`` from the measured batch
cadence; ``max_inflight``/``max_body_bytes`` reject before the body is
read.
"""

from __future__ import annotations

from typing import Optional

from k8s_spot_rescheduler_tpu_torch.service.server import (
    ServiceFault,
    ServiceServer,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils import logging as log


class PlannerSidecar(ServiceServer):
    """The historical single-tenant surface over the multi-tenant
    service (solving on ``device``, default cuda)."""

    def __init__(
        self,
        config: ReschedulerConfig,
        address: str = "127.0.0.1:8642",
        *,
        max_body_bytes: int = 128 << 20,
        busy_timeout_s: float = 30.0,
        max_inflight: int = 4,
        batch_window_s: Optional[float] = None,
        clock: Optional[Clock] = None,
        device=None,
    ):
        super().__init__(
            config,
            address,
            max_body_bytes=max_body_bytes,
            queue_timeout_s=busy_timeout_s,
            max_inflight=max_inflight,
            batch_window_s=batch_window_s,
            clock=clock,
            device=device,
        )

    def plan(self, body: dict) -> dict:
        """Decode + pack + solve through the batching queue (public
        entry for in-process callers; HTTP callers use /v1/plan)."""
        return self.plan_json(body)

    def serve_forever(self) -> None:
        log.info("planner sidecar listening on %s", self.address)
        super().serve_forever()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="spot-rescheduler-sidecar")
    ap.add_argument("--listen", default="127.0.0.1:8642")
    ap.add_argument("--solver", default="torch", choices=["torch", "numpy"])
    ap.add_argument("--device", default="cuda",
                    help="where batches solve: cuda (default) or cpu")
    ap.add_argument("--max-body-mb", type=int, default=128,
                    help="reject /v1/plan snapshots larger than this (413)")
    ap.add_argument("--busy-timeout", type=float, default=30.0,
                    help="seconds a request may wait in the batching "
                         "queue before 503 (backpressure; Retry-After "
                         "reports the measured batch cadence)")
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="reject /v1/plan immediately (503) past this many "
                         "concurrent requests — bounds worst-case request "
                         "memory at max-inflight x max-body-mb")
    ap.add_argument("-v", "--verbosity", type=int, default=0)
    args = ap.parse_args(argv)
    log.setup(args.verbosity)
    sidecar = PlannerSidecar(
        ReschedulerConfig(solver=args.solver), args.listen,
        max_body_bytes=args.max_body_mb << 20,
        busy_timeout_s=args.busy_timeout,
        max_inflight=args.max_inflight,
        device=args.device,
    )
    try:
        sidecar.serve_forever()
    except ServiceFault:
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
