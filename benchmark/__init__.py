"""The benchmark of the PyTorch/CUDA port (``ministark_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the checkout's root. See README.md."""
