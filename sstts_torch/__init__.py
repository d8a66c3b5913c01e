"""sstts_torch: the PyTorch/CUDA port of sstts for NVIDIA Hopper.

A second package beside the JAX reference `sstts`, which it never imports.
Entry points: `python -m sstts_torch.cli {train,evaluate,precompute,synthesize}`
and, from Python, `sstts_torch.synthesize.Synthesizer`, `sstts_torch.train.train`
and `sstts_torch.evaluate.evaluate`.  The hand-written CUDA
kernels live in `sstts_torch/csrc/` and are built with `nvcc` on first use
(`sstts_torch.ops.build`).
"""
