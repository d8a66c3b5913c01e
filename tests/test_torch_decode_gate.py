"""The per-shape gates of kernels B4 and B6: a text width past a kernel's
reach takes the plain loop, decided from the shape before anything is
launched, as the reference's synthesis gate does (`sstts/synthesize.py:
281-296`) and as its teacher "auto" (always the scan) does.

The reach is the library's count of shared memory, asked on the card only;
here it is given (`decode_route`, `teacher_route` are pure functions) or
the library's search is replaced by a stand-in, so that the Synthesizer's
and the model's routing run on the CPU.  No JAX here; torch on one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sstts_torch.config import tiny_config
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import decoder as dec
from sstts_torch.ops import teacher as tops
from sstts_torch.synthesize import Synthesizer

torch.set_num_threads(1)

CUDA = torch.device("cuda")
REACH = 15792  # B4's reach at the default widths on the H100 (chip_smoke.py reads it)


@pytest.mark.parametrize("override", ["auto", "fused", None])
def test_synthesis_gate_routes_past_the_reach_to_the_plain_loop(override):
    """"auto" and an explicit "fused" resolve to the kernel on the card and
    take it up to the reach, the plain loop past it; "xla" stays."""
    arch = tiny_config().arch
    impl = dec.resolve_decoder_impl(override, arch, CUDA)
    assert impl == "fused"
    for T, want in ((1, "fused"), (REACH - 1, "fused"), (REACH, "fused"),
                    (REACH + 1, "xla"), (4 * REACH, "xla")):
        assert dec.decode_route(impl, T, REACH) == want, T
    assert dec.decode_route("xla", 8, REACH) == "xla"
    assert dec.decode_route(impl, 10**6, None) == "fused"  # the CPU's plain version


def test_teacher_gate_auto_takes_the_scan_and_fused_raises():
    arch = tiny_config().arch
    auto = tops.resolve_teacher_impl("auto", arch, CUDA)
    assert auto == tops.resolve_teacher_impl("fused", arch, CUDA) == "fused"
    for override in ("auto", None):
        assert tops.teacher_route(override, auto, 100, 100) == "fused"
        assert tops.teacher_route(override, auto, 101, 100) == "xla"
        assert tops.teacher_route(override, auto, 10**6, None) == "fused"
    assert tops.teacher_route("fused", "fused", 100, 100) == "fused"
    with pytest.raises(NotImplementedError, match=r"T=101 .*T up to 100"):
        tops.teacher_route("fused", "fused", 101, 100)
    assert tops.teacher_route("xla", "xla", 101, 100) == "xla"


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, max_text_len=96),
                      inference=dataclasses.replace(cfg.inference, max_decoder_steps=5,
                                                    griffin_lim_iters=2))
    return cfg, init_state_dict(cfg.arch, cfg.dataset, 0)


def _stand_in_reach(monkeypatch, module, reach, asked):
    """Replace `module.text_reach` (the library's search) by a fixed reach,
    counting the widths it is asked for."""

    def text_reach(widths, device):
        asked.append((widths, device))
        return reach

    monkeypatch.setattr(module, "text_reach", text_reach)


def _on_the_card(synth, monkeypatch):
    """Resolve and route the Synthesizer's decoder as on the card (its
    decodes still run here on the CPU)."""
    cfg = synth.cfg
    synth._decoder_impl = dec.resolve_decoder_impl(cfg.inference.decoder_impl, cfg.arch, CUDA)
    route = synth._decode_route
    monkeypatch.setattr(synth, "_decode_route", lambda model, T, dev: route(model, T, CUDA))


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_synthesis_past_the_reach_is_the_xla_decode(tiny, monkeypatch, impl):
    """A batch of width 64 past a reach of 63 takes the plain loop under
    "auto" and "fused", and its audio equals a decoder_impl="xla"
    Synthesizer's at the same seed bit for bit (dropout on: both draw from
    one seed); a batch of width 32 takes the kernel; `decode_routes`
    records both.  The reach is asked once for the widths."""
    cfg, params = tiny
    asked = []
    _stand_in_reach(monkeypatch, dec, 63, asked)
    gated_cfg = cfg.replace(inference=dataclasses.replace(cfg.inference, decoder_impl=impl))
    gated = Synthesizer(gated_cfg, params, seed=7, device="cpu")
    _on_the_card(gated, monkeypatch)
    xla_cfg = cfg.replace(inference=dataclasses.replace(cfg.inference, decoder_impl="xla"))
    xla = Synthesizer(xla_cfg, params, seed=7, device="cpu")
    texts = ["hello world", "a longer one to speak"]
    got = gated.synthesize_batch(texts, text_bucket=64)
    want = xla.synthesize_batch(texts, text_bucket=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    short = gated.synthesize_batch(texts, text_bucket=32)
    assert gated.decode_routes == {64: "xla", 32: "fused"}
    assert xla.decode_routes == {64: "xla"}
    assert {w for w, _ in asked} == {dec.cell_widths(gated.model.decoder_cell)}
    assert all(np.isfinite(w).all() for w in short)


def test_synthesis_up_to_the_reach_is_the_kernel(tiny, monkeypatch):
    cfg, params = tiny
    _stand_in_reach(monkeypatch, dec, 64, [])
    synth = Synthesizer(cfg, params, seed=7, device="cpu")
    _on_the_card(synth, monkeypatch)
    calls = []
    real = dec.decode_steps_plain
    monkeypatch.setattr(dec, "decode_steps_plain",
                        lambda p: calls.append(p.memory.shape) or real(p))
    synth.synthesize_batch(["hello world"], text_bucket=64)
    assert synth.decode_routes == {64: "fused"} and calls == [(1, 64, 32)]


def test_cell_widths_are_the_kernels():
    """`cell_widths` names the widths `_DecodeArgs` and `_TeacherArgs` take
    from the cell (their shared memory beside T)."""
    cfg = tiny_config()
    model = Tacotron(cfg.arch, cfg.dataset)
    cell = model.decoder_cell
    a = cfg.arch
    Dm = 2 * a.encoder_gru_units
    assert dec.cell_widths(cell) == (cfg.dataset.n_mels, *a.prenet_units, Dm,
                                     a.attention_units, a.attention_gru_units,
                                     a.decoder_gru_units, a.reduction_factor)
    assert tops.cell_widths(cell) == (a.prenet_units[-1], Dm, a.attention_units,
                                      a.attention_gru_units, a.decoder_gru_units)


@pytest.mark.parametrize("override", ["auto", None, "fused", "xla"])
def test_teacher_scan_gate_in_the_model(override, monkeypatch):
    """The model's choice on the card (`scan_impl`): "auto" past the reach
    is the plain scan, an explicit "fused" past it raises by name, and at
    the reach both are the kernel; "xla" is always the scan."""
    cfg = tiny_config()
    model = Tacotron(cfg.arch, cfg.dataset, teacher_impl=override)
    cell = model.decoder_cell
    asked = []
    _stand_in_reach(monkeypatch, tops, 40, asked)
    kernel = "xla" if override == "xla" else "fused"
    assert tops.scan_impl(override, cell, 40, CUDA) == kernel
    if override == "fused":
        with pytest.raises(NotImplementedError, match="T=41"):
            tops.scan_impl(override, cell, 41, CUDA)
    else:
        assert tops.scan_impl(override, cell, 41, CUDA) == "xla"
    assert all(w == tops.cell_widths(cell) for w, _ in asked)
    assert tops.scan_impl(override, cell, 10**6, "cpu") == (
        "fused" if override == "fused" else "xla")


def test_teacher_forward_past_the_reach(monkeypatch):
    """A teacher-forced forward and its gradient routed as on the card, at a
    reach of 10 and a text width of 16: "auto" runs the plain scan (the
    "xla" forward's numbers bit for bit, the fused scan not called), an
    explicit "fused" raises NotImplementedError before the scan; at a reach
    of 16 "auto" takes the fused scan (its plain version here)."""
    from sstts_torch.model import tacotron as tac

    cfg = tiny_config()
    params = init_state_dict(cfg.arch, cfg.dataset, 0)
    real = tops.scan_impl
    monkeypatch.setattr(tac.teacher_ops, "scan_impl",
                        lambda override, cell, T, dev: real(override, cell, T, CUDA))
    scans = []
    fused = tops.fused_teacher_scan_ad
    monkeypatch.setattr(tac.teacher_ops, "fused_teacher_scan_ad",
                        lambda *a: scans.append(a[1].shape) or fused(*a))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(2, 30, (2, 16), generator=g)
    mel = torch.randn(2, 12, cfg.dataset.n_mels, generator=g)

    def forward(impl, reach):
        _stand_in_reach(monkeypatch, tops, reach, [])
        model = Tacotron(cfg.arch, cfg.dataset, teacher_impl=impl)
        model.load_state_dict(params)
        model.train()
        out = model(ids, mel, None, torch.Generator().manual_seed(2))
        loss = out["mel"].square().mean() + out["alignments"].square().mean()
        loss.backward()
        return out, model.decoder_cell.attn_gru.wh.grad

    auto, auto_grad = forward("auto", 10)
    assert scans == []
    xla, xla_grad = forward("xla", 10)
    for k in ("mel", "linear", "stop_logits", "alignments"):
        assert torch.equal(auto[k], xla[k]), k
    assert torch.equal(auto_grad, xla_grad)
    with pytest.raises(NotImplementedError, match="T=16"):
        forward("fused", 10)
    forward("auto", 16)
    assert len(scans) == 1
