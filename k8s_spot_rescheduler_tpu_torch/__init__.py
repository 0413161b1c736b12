"""PyTorch and CUDA port of the spot rescheduler.

The package mirrors ``k8s_spot_rescheduler_tpu``'s layout (``utils/``,
``models/``, ``predicates/``, ``solver/``, ``ops/``, ``planner/``,
``actuator/``, ``loop/``, ``io/``, ``metrics/``, ``cli/``) and is held
bit-for-bit against it. It imports torch, numpy and the standard
library, never jax and nothing of the JAX package. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (``--device cpu``).

Run the controller on a synthetic cluster::

    python -m k8s_spot_rescheduler_tpu_torch --cluster synthetic:1 --ticks 3
"""

__version__ = "0.1.0"

VERSION = __version__
