"""The benchmark of the PyTorch and CUDA port (``ssqp_tpu_torch``) on one
NVIDIA H100. ``python3 gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; see ``run.py``."""
