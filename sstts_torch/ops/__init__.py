"""Hand-written CUDA kernels with their plain PyTorch versions.

Each kernel wrapper counts its CUDA launches in a `launches` attribute;
`kernel_wrappers` lists them so that a run can show the main path went
through every kernel.
"""


def kernel_wrappers():
    """name -> wrapper (each has an integer `launches`) of every kernel."""
    from sstts_torch.dsp.gl_fused import reproject_analyze
    from sstts_torch.ops.decoder import decode_steps
    from sstts_torch.ops.gru import gru_sequence

    return {
        "gru_sequence": gru_sequence,
        "fused_decode": decode_steps,
        "fused_reproject_analyze": reproject_analyze,
    }
