"""The benchmark of dram_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards: `python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` (see portbench/README.md)."""
