"""The plain reference that decides `correct`: Tacotron synthesis and its
train step in plain PyTorch, written from the model's definition, with
no kernel, no cache and no batching of its own.

It imports nothing of the program (`sstts_torch`), of the JAX package or
of JAX (`tests/test_portbench_imports.py` holds that), and takes nothing
the program made: the weights, texts and waveforms come from the
benchmark, and what the program derives from them (text ids, dropout
seeds and bits, the Griffin-Lim matrices, features) is worked out here
again.

Precision: `Precision` names the dtype of the parts the configuration
states in float32 (the model), whether their products may take TF32, and
the operand type of the parts it states in bfloat16 (the decode's and the
teacher-forced scan's products, the Griffin-Lim loop's DFT products, each
accumulated in float32).  `STATED` is the configuration's; the controls
step down from it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


class Precision(NamedTuple):
    #: dtype of the parts stated in float32.
    full: torch.dtype
    #: operand type of the products stated in bfloat16.
    half: torch.dtype
    #: whether the float32 parts' products and convolutions take TF32.
    tf32: bool = False


STATED = Precision(torch.float32, torch.bfloat16)
#: One step below the stated precision everywhere: the float32 parts with
#: TF32 on, the bfloat16 products on float8 (e4m3) operands, each scaled
#: by its tensor's largest magnitude.
CONTROL_ALL = Precision(torch.float32, torch.float8_e4m3fn, tf32=True)
#: The model in bfloat16, the bfloat16 products as stated.
CONTROL_MODEL = Precision(torch.bfloat16, torch.bfloat16)

CONTROLS = {"all_lower": CONTROL_ALL, "model_bf16": CONTROL_MODEL}

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to `dtype`, in float32.  A float8 operand takes one scale
    for the tensor, its largest magnitude at the format's largest finite
    value, as float8 products are run."""
    if dtype in _FP8:
        amax = x.detach().abs().amax().float()
        s = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
        return (x.float() / s).to(dtype).float() * s
    return x.to(dtype).float()


@contextlib.contextmanager
def matmul_precision(P: Precision = STATED):
    """Float32 products on CUDA for the duration: full float32, or TF32
    where `P.tf32`."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cuda.matmul.allow_bf16_reduced_precision_reduction)
    b.cudnn.allow_tf32 = P.tf32
    b.cuda.matmul.allow_tf32 = P.tf32
    b.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved
