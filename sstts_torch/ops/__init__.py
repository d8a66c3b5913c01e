"""Hand-written CUDA kernels with their plain PyTorch versions.

Each kernel wrapper counts its CUDA launches in a `launches` attribute;
`kernel_wrappers` lists them so that a run can show the main path went
through every kernel.
"""

import torch


def kernel_wrappers():
    """name -> wrapper (each has an integer `launches`) of every kernel."""
    from sstts_torch.dsp.gl_fused import gl_iteration, reproject_analyze
    from sstts_torch.dsp.reproject import reproject_frames
    from sstts_torch.ops.decoder import decode_steps
    from sstts_torch.ops.gru import gru_sequence, gru_sequence_backward
    from sstts_torch.ops.teacher import fused_teacher_scan

    return {
        "gru_sequence": gru_sequence,
        "gru_sequence_backward": gru_sequence_backward,
        "fused_teacher_scan": fused_teacher_scan,
        "fused_decode": decode_steps,
        "fused_reproject_analyze": reproject_analyze,
        "reproject_frames_pallas": reproject_frames,
        "fused_gl_iteration": gl_iteration,
    }


def require_no_grad(what: str, *tensors) -> None:
    """Refuse to run an inference-only kernel where autograd would need its
    gradient: its output would silently carry none."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what} is inference-only and has no gradient; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
