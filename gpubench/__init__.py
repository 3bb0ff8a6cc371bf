"""The benchmark of owlvit_tpu_torch on NVIDIA GPUs (see BENCHMARK.json).

Run a cell: python3 gpubench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>.
"""
