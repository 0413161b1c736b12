"""The benchmark of the PyTorch and CUDA port
(``k8s_spot_rescheduler_tpu_torch``): cells of ``BENCHMARK.json`` run by
``python3 -m benchmark``; see ``benchmark/README.md``."""
