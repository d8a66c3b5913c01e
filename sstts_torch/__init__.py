"""sstts_torch: the PyTorch/CUDA port of sstts for NVIDIA Hopper.

A second package beside the JAX reference `sstts`, which it never imports.
Entry points: `python -m sstts_torch.cli {train,evaluate,precompute,synthesize}`
and, from Python, `sstts_torch.Synthesizer` (`sstts_torch.synthesize`),
`sstts_torch.train.train` and `sstts_torch.evaluate.evaluate`.  The
hand-written CUDA kernels live in `sstts_torch/csrc/` and are built with
`nvcc` on first use (`sstts_torch.ops.build`).  Importing the package
imports no `torch`: the config classes are plain dataclasses and
`Synthesizer` loads on first access, as `sstts/__init__.py` keeps its
package free of JAX.
"""

from sstts_torch.config import (
    ArchitectureConfig,
    Config,
    DatasetConfig,
    EvaluationConfig,
    InferenceConfig,
    TrainingConfig,
    tiny_config,
)

__all__ = [
    "ArchitectureConfig",
    "Config",
    "DatasetConfig",
    "EvaluationConfig",
    "InferenceConfig",
    "TrainingConfig",
    "tiny_config",
    "Synthesizer",
]

# Only names that do not collide with submodules (sstts_torch.train and the
# like keep resolving to their modules).
_LAZY = {"Synthesizer": ("sstts_torch.synthesize", "Synthesizer")}


def __getattr__(name: str):
    """Lazy top-level entry points: `import sstts_torch` stays torch-free."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'sstts_torch' has no attribute {name!r}")
