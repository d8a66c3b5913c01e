"""The port's package boundary: no JAX inside, same config fingerprints,
the card by default, no launches on the CPU, and clear refusals for what
the port does not implement."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sstts.config as jax_config
import sstts_torch.config as port_config
from sstts_torch.synthesize import Synthesizer, check_supported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_sstts():
    """Importing every sstts_torch module leaves no jax, flax or sstts.*
    module behind (run in a fresh interpreter)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import sstts_torch\n"
        "names = ['sstts_torch'] + [m.name for m in pkgutil.walk_packages("
        "sstts_torch.__path__, 'sstts_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sstts'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for expected in (
        "sstts_torch.synthesize", "sstts_torch.convert",
        "sstts_torch.model.tacotron", "sstts_torch.ops.gru",
        "sstts_torch.ops.decoder", "sstts_torch.dsp.gl_fused",
        "sstts_torch.dsp.griffin_lim", "sstts_torch.data.text",
        "sstts_torch.train", "sstts_torch.checkpoint", "sstts_torch.ops.teacher",
        "sstts_torch.model.losses", "sstts_torch.data.pipeline",
        "sstts_torch.dsp.reproject", "sstts_torch.dsp.ops", "sstts_torch.data.wav",
        "sstts_torch.tools.compare_gl_builds", "sstts_torch.tools.ablate_gru",
        "sstts_torch.tools.sm_microbench", "sstts_torch.tools.path_walls",
        "sstts_torch.cli", "sstts_torch.evaluate", "sstts_torch.data.corpora",
        "sstts_torch.data.features_cache", "sstts_torch.data.statistics",
        "sstts_torch.dsp.resample", "sstts_torch.dsp.metrics",
        "sstts_torch.utils.logging", "sstts_torch.utils.visualization",
        "sstts_torch.tools.overfit_demo", "sstts_torch.model.attention",
        "sstts_torch.model.modules", "sstts_torch.model.rnn",
        "sstts_torch.model.decoder", "sstts_torch.utils.profiling",
        "sstts_torch.parallel.mesh", "sstts_torch.dsp.fft",
        "sstts_torch.data.native_loader", "sstts_torch.tools.mesh_steps",
    ):
        assert expected in res["modules"]


@pytest.mark.parametrize(
    "module", ["sstts_torch.parallel.mesh", "sstts_torch.dsp.fft", "sstts_torch.data.native_loader"]
)
def test_new_modules_import_cleanly(module):
    """Importing the mesh, the matmul FFT or the native loader (in a fresh
    interpreter) initializes no CUDA, joins no process group, starts no
    thread and builds nothing, and brings in no JAX or sstts module."""
    code = (
        "import importlib, json, sys, threading\n"
        f"importlib.import_module({module!r})\n"
        "import torch, torch.distributed as dist\n"
        "from sstts_torch.data import native_loader\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sstts'))\n"
        "print(json.dumps({'cuda': torch.cuda.is_initialized(), 'group': dist.is_initialized(),"
        " 'threads': threading.active_count(), 'bad': bad,"
        " 'built': native_loader._library.cache_info().currsize}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"cuda": False, "group": False, "threads": 1, "bad": [], "built": 0}


def test_package_names_match_the_reference_and_import_no_torch():
    """`import sstts_torch` gives the reference's top-level names (the
    config classes, `tiny_config`, a lazy `Synthesizer`) and, like `import
    sstts` with JAX, imports no torch until `Synthesizer` is asked for."""
    import sstts

    code = (
        "import json, sys\n"
        "import sstts_torch\n"
        "before = 'torch' in sys.modules\n"
        "names = sorted(sstts_torch.__all__)\n"
        "cls = sstts_torch.Synthesizer\n"
        "print(json.dumps({'before': before, 'names': names, 'after': 'torch' in sys.modules,"
        " 'cls': cls.__module__ + '.' + cls.__name__}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["before"] is False and res["after"] is True
    assert res["names"] == sorted(sstts.__all__)
    assert res["cls"] == "sstts_torch.synthesize.Synthesizer"
    import sstts_torch

    for name in sstts.__all__:
        if name != "Synthesizer":
            assert getattr(sstts_torch, name) is getattr(port_config, name)
    with pytest.raises(AttributeError):
        sstts_torch.Nothing  # noqa: B018


def test_profiling_helpers_match_the_reference(tmp_path):
    """`timed` returns the reference's keys; `trace` writes a trace file."""
    from sstts.utils import profiling as jprof
    from sstts_torch.utils import profiling

    got = profiling.timed(lambda x: x @ x, torch.ones(8, 8), trials=4, warmup=1)
    ref = jprof.timed(lambda x: x @ x, np.ones((8, 8), np.float32), trials=4, warmup=1)
    assert set(got) == set(ref)
    assert got["trials"] == 4.0 and 0.0 <= got["p10_s"] <= got["median_s"] <= got["p90_s"]
    with profiling.trace(tmp_path / "trace"):
        torch.ones(16).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.Config(),
        lambda m: m.tiny_config(),
        lambda m: m.with_fast_vocoder(m.Config()),
    ],
    ids=["default", "tiny", "fast_vocoder"],
)
def test_config_fingerprints_match(make):
    assert make(port_config).fingerprint() == make(jax_config).fingerprint()
    assert dataclasses.asdict(make(port_config)) == dataclasses.asdict(
        make(jax_config)
    )


def test_synthesizer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.tiny_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(cfg, {})


def test_kernel_wrappers_on_cpu_do_not_launch():
    """A wrapper given CPU tensors runs its plain version and counts no
    launch."""
    from sstts_torch.dsp.gl_fused import gl_iteration, reproject_analyze
    from sstts_torch.dsp.reproject import reproject_frames
    from sstts_torch.ops import kernel_wrappers
    from sstts_torch.ops.gru import gru_sequence

    before = {k: w.launches for k, w in kernel_wrappers().items()}
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.normal(size=(2, 5, 4)).astype(np.float32))
    wx = torch.as_tensor(rng.normal(size=(4, 9)).astype(np.float32))
    wh = torch.as_tensor(rng.normal(size=(3, 9)).astype(np.float32))
    y = gru_sequence(xs, wx, wh, torch.zeros(9), None, False)
    assert y.shape == (2, 5, 3)
    frames = torch.zeros(1, 4, 128)
    mag2 = torch.ones(1, 4, 128)
    q, s = reproject_analyze(
        frames, mag2, torch.zeros(128, 128), torch.ones(4, 128), 100, 25, 3
    )
    assert s is None and q.shape == (1, 4, 128)
    out = reproject_frames(torch.ones(1, 20, 512), 512, 100, 400, 1900)
    assert out.shape == (1, 20, 512)
    q = gl_iteration(
        frames, mag2, torch.zeros(128, 128), torch.zeros(128, 128),
        torch.ones(4, 128), 100, 25, 3,
    )
    assert q.shape == (1, 4, 128)
    after = {k: w.launches for k, w in kernel_wrappers().items()}
    assert after == before


def test_kernel_wrappers_list_all_seven():
    from sstts_torch.ops import kernel_wrappers

    assert sorted(kernel_wrappers()) == sorted([
        "gru_sequence", "gru_sequence_backward", "fused_teacher_scan",
        "fused_decode", "fused_reproject_analyze", "reproject_frames_pallas",
        "fused_gl_iteration",
    ])


def test_cpu_gradients_do_not_launch():
    """The GRU's and the teacher scan's gradient paths on CPU tensors run
    their plain versions and count no launch."""
    from sstts_torch.ops import kernel_wrappers
    from sstts_torch.ops.gru import gru_sequence
    from sstts_torch.ops.teacher import TeacherWeights, fused_teacher_scan_ad

    before = {k: w.launches for k, w in kernel_wrappers().items()}
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g).requires_grad_()  # noqa: E731
    y = gru_sequence(rand(2, 5, 4), rand(4, 9), rand(3, 9), rand(9), None, True)
    y.sum().backward()
    H, D, A, P = 4, 6, 5, 3
    w = TeacherWeights(
        rand(P + D, 3 * H), rand(H, 3 * H), rand(3 * H), rand(H, A), rand(A), rand(A),
        rand(H + D, H), rand(H), rand(H, 3 * H), rand(H, 3 * H), rand(3 * H),
        rand(H, 3 * H), rand(H, 3 * H), rand(3 * H),
    )
    xs, al = fused_teacher_scan_ad(w, rand(2, 3, P), rand(2, 7, D), rand(2, 7, A),
                                   torch.ones(2, 7), torch.float32)
    (xs.sum() + al.sum()).backward()
    assert w.attn_wx.grad is not None
    assert {k: w.launches for k, w in kernel_wrappers().items()} == before


_REFUSALS = [
    # As the JAX package: the fused iteration has no momentum variant, and
    # an unknown wire is refused.
    ({"inference": {"griffin_lim_iter_impl": "fused", "griffin_lim_momentum": 0.99}},
     "cpu", ValueError),
    ({"inference": {"wire_format": "opus"}}, "cpu", ValueError),
    # B2 and B5 on the card beyond their envelope (both loop dtypes, n_fft up
    # to 2048, at most 16 overlapping frames a side): a 23-sample hop of the
    # tiny config's 400-sample window (D = 17), and the f32 loop at n_fft 4096.
    ({"dataset": {"win_hop_ms": 2.875}}, "cuda", NotImplementedError),
    ({"inference": {"griffin_lim_iter_impl": "fused", "griffin_lim_fft_impl": "dft_high"},
      "dataset": {"n_fft": 4096}}, "cuda", NotImplementedError),
    # The decode kernel on an architecture it lacks: the reference's ValueError.
    ({"arch": {"attention_type": "local_luong"}, "inference": {"decoder_impl": "fused"}},
     "cpu", ValueError),
    # B3's width limit on the card (`ops/gru.py:MAX_HIDDEN`): a BiGRU past
    # H = 5456.
    ({"arch": {"encoder_gru_units": 5457}}, "cuda", NotImplementedError),
]


def _with(cfg, sections):
    return cfg.replace(**{
        name: dataclasses.replace(getattr(cfg, name), **fields)
        for name, fields in sections.items()
    })


@pytest.mark.parametrize("sections,device,error", _REFUSALS)
def test_unported_config_values_raise(sections, device, error):
    cfg = _with(port_config.tiny_config(), sections)
    with pytest.raises(error):
        check_supported(cfg, torch.device(device))


#: Values the port refused before it took every architecture of the
#: reference's model and every width its kernels take, with the decoder each
#: resolves to.
_ACCEPTED = [
    ({"arch": {"attention_type": "local_luong"}}, "cpu", "xla"),
    ({"arch": {"fused_conv_bank": True}}, "cpu", "xla"),
    ({"arch": {"compute_dtype": "bfloat16"}}, "cpu", "xla"),
    ({"inference": {"decoder_impl": "xla"}}, "cuda", "xla"),
    ({"arch": {"attention_type": "local_luong"}}, "cuda", "xla"),
    ({"arch": {"compute_dtype": "bfloat16", "fused_conv_bank": True}}, "cuda", "fused"),
    # Widths past the kernels' single-block limits: B3's wide kind (H past
    # 137) and B4's column panels (past 1024 columns).
    ({"arch": {"encoder_gru_units": 160}}, "cuda", "fused"),
    ({"arch": {"attention_units": 1280}, "inference": {"decoder_impl": "fused"}},
     "cuda", "fused"),
]


@pytest.mark.parametrize("sections,device,decoder", _ACCEPTED)
def test_architecture_values_are_accepted(sections, device, decoder):
    cfg = _with(port_config.tiny_config(), sections)
    assert check_supported(cfg, torch.device(device)) == decoder


@pytest.mark.parametrize(
    "fields",
    [
        {"wire_format": "mulaw8"}, {"wire_format": "adpcm2"},
        {"griffin_lim_iter_impl": "split", "griffin_lim_fft_impl": "dft_highest"},
        {"griffin_lim_iter_impl": "fused"},
        {"griffin_lim_fft_impl": "xla", "griffin_lim_momentum": 0.99},
    ],
)
def test_serving_config_values_are_accepted_on_the_card(fields):
    cfg = port_config.tiny_config()
    cfg = cfg.replace(inference=dataclasses.replace(cfg.inference, **fields))
    check_supported(cfg, torch.device("cuda"))
