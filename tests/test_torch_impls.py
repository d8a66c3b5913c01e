"""Which implementation runs where: `resolve_decoder_impl` and
`resolve_teacher_impl` over every override, architecture and device, held
to the reference's own resolvers, and the kernels' widths (B3's kind of
kernel by `sstts_torch.ops.gru.kernel_config`, refused past H = 5456; B4 and B6
at any width).  Resolution is a pure function of the config and the device:
nothing here needs a card or launches anything.

The decoder on CUDA must resolve as the reference's does on its TPU (the
backend where its kernel runs) and on the CPU as the reference's does on
the CPU; "fused" on an architecture the kernel lacks raises the
reference's ValueError.  The teacher-forced scan differs by design in one
cell: the reference's "auto" is its scan everywhere (its TPU kernel lost
there), the port's "auto" on CUDA is B6 where B6 implements the
architecture.
"""

import dataclasses
import re
import types
from pathlib import Path

import pytest
import torch

import sstts.synthesize as jsynth
from sstts.config import tiny_config as jax_tiny_config
from sstts.ops import pallas_decoder as jpd
from sstts_torch.config import tiny_config
from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec_ops
from sstts_torch.ops import gru as gru_ops
from sstts_torch.ops import teacher as tops
from sstts_torch.synthesize import Synthesizer

OVERRIDES = (None, "auto", "xla", "fused")
ARCHS = {
    "bahdanau": {},
    "luong": {"attention_type": "local_luong"},
    "three_decoder_grus": {"decoder_gru_layers": 3},
    "one_prenet_layer": {"prenet_units": (32,)},
}
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _arch(name, cfg=None):
    cfg = cfg or tiny_config()
    return dataclasses.replace(cfg.arch, **ARCHS[name])


def _outcome(fn):
    """The value `fn()` returns, or (the exception's type, its message)."""
    try:
        return fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)


def _reference_decoder(override, arch, backend, monkeypatch):
    """The reference's `Synthesizer._resolve_decoder_impl` with JAX's
    default backend reading `backend`."""
    cfg = jax_tiny_config()
    cfg = cfg.replace(arch=arch, inference=dataclasses.replace(cfg.inference,
                                                               decoder_impl=override))
    monkeypatch.setattr(jsynth.jax, "default_backend", lambda: backend)
    fake = types.SimpleNamespace(cfg=cfg, _gspmd_multidev=False)
    return _outcome(lambda: jsynth.Synthesizer._resolve_decoder_impl(fake))


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("override", OVERRIDES, ids=str)
def test_decoder_impl_matches_the_reference(override, arch_name, monkeypatch):
    port_arch = _arch(arch_name)
    jax_arch = _arch(arch_name, jax_tiny_config())
    assert dec_ops.supports_arch(port_arch) == jpd.supports_arch(jax_arch)
    for device, backend in ((CPU, "cpu"), (CUDA, "tpu")):
        got = _outcome(lambda: dec_ops.resolve_decoder_impl(override, port_arch, device))
        ref = _reference_decoder(override, jax_arch, backend, monkeypatch)
        assert got == ref, (device, got, ref)
    if override == "fused" and arch_name != "bahdanau":
        assert got[0] is ValueError


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("override", OVERRIDES, ids=str)
def test_teacher_impl_matches_the_reference(override, arch_name):
    port_arch = _arch(arch_name)
    jax_arch = _arch(arch_name, jax_tiny_config())
    assert tops.supports_teacher_arch(port_arch) == jpd.supports_teacher_arch(jax_arch)
    ref = _outcome(lambda: jpd.resolve_teacher_impl(override, jax_arch))
    assert _outcome(lambda: tops.resolve_teacher_impl(override, port_arch, CPU)) == ref
    got = _outcome(lambda: tops.resolve_teacher_impl(override, port_arch, CUDA))
    if override in (None, "auto") and tops.supports_teacher_arch(port_arch):
        assert got == "fused"  # B6 on the card; the reference's "auto" is its scan
    else:
        assert got == ref


@pytest.mark.parametrize("override", ["auto", "fused"])
def test_wide_products_take_the_kernels_on_the_card(override):
    """Products past the 1024 columns of a panel (B4's and B6's query and
    keys at 1280 and 4096 columns, the recurrent products of 512-unit GRUs:
    1536) resolve to the kernels on CUDA, which stream them in column
    panels; on the CPU the plain versions take them, as before."""
    arch = tiny_config().arch
    for fields in ({"attention_units": 1280}, {"attention_units": 4096},
                   {"attention_gru_units": 512, "decoder_gru_units": 512}):
        wide = dataclasses.replace(arch, **fields)
        assert dec_ops.resolve_decoder_impl(override, wide, CUDA) == "fused"
        assert tops.resolve_teacher_impl(override, wide, CUDA) == "fused"
        expected = "fused" if override == "fused" else "xla"
        assert dec_ops.resolve_decoder_impl(override, wide, CPU) == expected
        assert tops.resolve_teacher_impl(override, wide, CPU) == expected
        assert dec_ops.resolve_decoder_impl("xla", wide, CUDA) == "xla"
    # The frame projection past a panel: r * n_mels = 8 * 129 = 1032 columns
    # (the resolver needs no n_mels: no width is refused).
    edge = dataclasses.replace(arch, reduction_factor=8)
    assert dec_ops.resolve_decoder_impl(override, edge, CUDA) == "fused"
    assert len(dec_ops.panels(8 * 129)) == 2 and len(dec_ops.panels(4096)) == 4


#: Widths and the kind of kernel each takes on the card (None: refused).
_GRU_KINDS = {1: "generic", 16: "generic", 128: "h128", 137: "generic", 138: "wide",
              160: "wide", 512: "wide", 522: "wide", 523: "grid", 544: "grid", 752: "grid",
              1104: "grid",
              1419: "grid", 1420: "grid", 2113: "grid", 5456: "grid", 5457: None}


@pytest.mark.parametrize("hidden", sorted(_GRU_KINDS))
def test_gru_width_check(hidden):
    """The card's GRU kernels take H up to MAX_HIDDEN (5456): the register
    kernels at 128, the generic ones up to 137, the wide ones (a cluster a
    tile of the batch) up to 522, the grid ones (a cooperative grid a direction,
    whose blocks stream past 1419 what their shared memory cannot hold of
    their slice of Wh) up to 5456; a wider GRU raises NotImplementedError
    naming MAX_HIDDEN on CUDA only, from `check_width` and from `check_arch`
    for either CBHG's GRU."""
    kinds = {gru_ops.KIND_H128: "h128", gru_ops.KIND_GENERIC: "generic",
             gru_ops.KIND_WIDE: "wide", gru_ops.KIND_GRID: "grid"}
    gru_ops.check_width(hidden, CPU)
    for field in ("encoder_gru_units", "post_gru_units"):
        arch = dataclasses.replace(tiny_config().arch, **{field: hidden})
        gru_ops.check_arch(arch, CPU)
        if _GRU_KINDS[hidden] is not None:
            gru_ops.check_width(hidden, CUDA)
            gru_ops.check_arch(arch, CUDA)
            assert kinds[gru_ops.kernel_config(hidden)[0]] == _GRU_KINDS[hidden]
        else:
            for check in (lambda: gru_ops.check_width(hidden, CUDA),
                          lambda: gru_ops.check_arch(arch, CUDA)):
                with pytest.raises(NotImplementedError,
                                   match=rf"MAX_HIDDEN = 5456, .*H={hidden}$"):
                    check()


def test_gru_width_limit_follows_the_kernel_source():
    """`generic_smem_bytes` repeats csrc/gru.cu's two shared-memory counts,
    which both fit in a block up to H = 137; past it the wide kernels, whose
    block size and largest cluster are the source's, reach 522 (with B = 32
    in one wave of clusters), and the
    grid ones MAX_HIDDEN = 5456, the source's kGridMaxHidden, where a block
    owns 42 units (chip_smoke.py holds `wide_smem_bytes` and
    `grid_smem_bytes` to the library's counts at every H past 137)."""
    src = Path(build.CSRC / "gru.cu").read_text()
    formulas = [
        re.search(rf"int {name}\(int H\) {{ return (.*?); }}", src).group(1)
        for name in ("sstts_gru_smem_bytes", "sstts_gru_bwd_smem_bytes")
    ]
    for h in (1, 16, 128, 137, 138, 160):
        assert gru_ops.generic_smem_bytes(h) == tuple(eval(f, {"H": h}) for f in formulas)
    assert gru_ops.MAX_HIDDEN == 5456
    assert int(re.search(r"constexpr int kGridMaxHidden = (\d+);", src).group(1)) == 5456
    assert gru_ops.grid_shape(gru_ops.MAX_HIDDEN, False)["U"] == 42
    assert max(gru_ops.generic_smem_bytes(137)) <= build.MAX_SMEM
    assert max(gru_ops.generic_smem_bytes(138)) > build.MAX_SMEM
    for name, value in (("kWideThreads", gru_ops.WIDE_THREADS),
                        ("kMaxCluster", gru_ops.MAX_CLUSTER)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    assert gru_ops.kernel_config(522) == (gru_ops.KIND_WIDE, 16)
    assert gru_ops.kernel_config(523) == (gru_ops.KIND_GRID, 131)
    assert gru_ops.kernel_config(544) == (gru_ops.KIND_GRID, 109)
    assert gru_ops.kernel_config(1419) == (gru_ops.KIND_GRID, 129)
    assert gru_ops.kernel_config(1420) == (gru_ops.KIND_GRID, 130)


def test_synthesizer_resolves_before_anything_runs():
    """The Synthesizer resolves its decoder at construction: "fused" with
    Luong raises the reference's ValueError there; "xla" and Luong's
    "auto" take the plain loop."""
    cfg = tiny_config()
    luong = cfg.replace(arch=dataclasses.replace(cfg.arch, attention_type="local_luong"))
    fused = luong.replace(inference=dataclasses.replace(luong.inference, decoder_impl="fused"))
    with pytest.raises(ValueError, match="decoder_impl='fused' implements only Bahdanau"):
        Synthesizer(fused, {}, device="cpu")
    from sstts_torch.model.tacotron import init_state_dict

    params = init_state_dict(luong.arch, luong.dataset, seed=0)
    assert Synthesizer(luong, params, device="cpu")._decoder_impl == "xla"


@pytest.mark.parametrize("override", [None, "auto"], ids=str)
def test_a_mesh_keeps_the_kernels_on_every_rank(override, monkeypatch):
    """An intended difference (ROADMAP C): under a multi-device GSPMD mesh
    the reference pins its decoder to the XLA scan (GSPMD cannot partition
    a custom call), and keeps its kernel under `shard_map`; the port runs
    whole modules on each shard, so the mesh takes no part in the choice
    and "auto" is B4 on every card, as the reference's `shard_map` mode."""
    arch = _arch("bahdanau")
    cfg = jax_tiny_config()
    cfg = cfg.replace(inference=dataclasses.replace(cfg.inference, decoder_impl=override))
    monkeypatch.setattr(jsynth.jax, "default_backend", lambda: "tpu")
    for gspmd_multidev, want in ((True, "xla"), (False, "fused")):
        fake = types.SimpleNamespace(cfg=cfg, _gspmd_multidev=gspmd_multidev)
        assert jsynth.Synthesizer._resolve_decoder_impl(fake) == want
    assert dec_ops.resolve_decoder_impl(override, arch, CUDA) == "fused"
    assert tops.resolve_teacher_impl(override, arch, CUDA) == "fused"
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.parallel.mesh import make_mesh

    pcfg = tiny_config()
    params = init_state_dict(pcfg.arch, pcfg.dataset, 0)
    one = Synthesizer(pcfg, params, device="cpu")
    mesh = Synthesizer(pcfg, params, device="cpu", mesh=make_mesh(devices=[CPU] * 2))
    assert mesh._decoder_impl == one._decoder_impl
