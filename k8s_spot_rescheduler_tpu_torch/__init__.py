"""PyTorch and CUDA port of the spot rescheduler's device path.

The package mirrors ``k8s_spot_rescheduler_tpu``'s layout (``models/``,
``solver/``, ``ops/``, ``planner/``) and is held bit-for-bit against it.
It imports torch and numpy, never jax and nothing of the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
