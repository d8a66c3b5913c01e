"""The benchmark of `sstts_torch`, the PyTorch and CUDA port, on NVIDIA
cards: `python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (see `run.py`)."""
