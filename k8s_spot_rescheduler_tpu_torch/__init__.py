"""PyTorch and CUDA port of the spot rescheduler.

The package mirrors ``k8s_spot_rescheduler_tpu``'s layout (``utils/``,
``models/``, ``predicates/``, ``solver/``, ``ops/``, ``planner/``,
``actuator/``, ``loop/``, ``io/``, ``metrics/``, ``cli/``, ``service/``,
``parallel/``, ``sidecar/``) and is held
bit-for-bit against it. It imports torch, numpy and the standard
library, never jax and nothing of the JAX package. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (``--device cpu``).

Run the controller on a synthetic cluster::

    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3

or the multi-tenant planner service, and an agent planning through it::

    python -m k8s_spot_rescheduler_tpu_torch --serve 127.0.0.1:8642
    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 \
        --ticks 3 --planner-url http://127.0.0.1:8642
"""

__version__ = "0.1.0"

VERSION = __version__
