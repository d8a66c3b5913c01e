"""The full barriers of the Griffin-Lim kernels' GEMM2 ring (B2 and B5,
`sstts_torch/csrc/gl_tail.cuh`), stated in Python and held to the source.

The producer fills ring stage n = 2 m + wg (warpgroup wg's m-th stage) into
slot n % kStages; kStages is odd, so the two consumer warpgroups take a slot
by turns.  A consumer waits on a barrier by the parity of the phase it
wants, which is only sound if, each time it waits, the barrier is at most
one phase behind: waiting on a barrier two phases behind reads the parity
of the phase before as done.  With one full barrier a slot shared by both
warpgroups a warpgroup's next use of a slot is two phases after its last;
with a barrier a warpgroup and slot it is the next one.  The stress order of
`SSTTS_RING_STRESS` must stay a permutation of each pair's stages in which
no stage's copies wait on a stage issued later.  No JAX, no card.
"""

import re

import pytest

from sstts_torch.ops import build

SRC = (build.CSRC / "gl_tail.cuh").read_text()
K_STAGES = int(re.search(r"constexpr int kStages = (\d+);", SRC).group(1))


def stress_order(n_stages: int, n_kc: int):
    """The producer's issue order under SSTTS_RING_STRESS (gl_tail.cuh)."""
    out = []
    for i in range(n_stages):
        q = i % (2 * n_kc)
        out.append(i - q + (2 * q if q <= 2 else 2 * q - 5) if n_kc >= 3 and 1 <= q <= 4
                   else i)
    return out


def phases(shared: bool, n_kc: int, n_pairs: int):
    """For each warpgroup, its stages' (barrier, phase of that barrier)."""
    uses, out = {}, {0: [], 1: []}
    for n in range(2 * n_kc * n_pairs):
        wg, slot = n & 1, n % K_STAGES
        bar = slot if shared else (wg, slot)
        out[wg].append((bar, uses.get(bar, 0)))
        uses[bar] = uses.get(bar, 0) + 1
    return out


def test_the_ring_is_odd_and_each_warpgroup_has_its_barriers():
    assert K_STAGES % 2 == 1  # why the slots serve the warpgroups by turns
    assert "uint64_t* const full = s.full(wg);" in SRC and "mbar_wait(full + slot, phase);" in SRC
    assert "uint64_t* full = s.full(wg) + slot;" in SRC
    assert "if (SSTTS_SHARED_FULL ? wrapped : ++visits == kStages) visits = 0, phase ^= 1;" in SRC
    assert "? i - q + (q <= 2 ? 2 * q : 2 * q - 5)" in SRC  # `stress_order`
    assert "issue(slot, phase, wg, kc, pair);" in SRC  # the unstressed order: n = 0, 1, ...
    extra = int(re.search(r"constexpr int kExtraBarriers = (\d+);", SRC).group(1))
    size = int(re.search(r"constexpr int kBarrierBytes = (\d+);", SRC).group(1))
    f_slots = int(re.search(r"constexpr int kFSlots = (\d+);", SRC).group(1))
    assert (3 * K_STAGES + 2 * f_slots + extra) * 8 <= size


@pytest.mark.parametrize("n_kc,n_pairs", [(3, 1), (18, 8), (33, 8), (18, 1), (5, 3)])
def test_a_warpgroup_waits_each_phase_of_its_barriers_in_turn(n_kc, n_pairs):
    """A barrier a warpgroup and slot: each wait is the phase after the
    warpgroup's last wait on that barrier, and the source's parity (flipped
    every kStages stages of the warpgroup) is that phase's."""
    for wg, seq in phases(False, n_kc, n_pairs).items():
        last, parity, visits, slot = {}, 0, 0, wg
        for bar, phase in seq:
            assert bar == (wg, slot) and phase == last.get(bar, -1) + 1
            assert parity == phase & 1
            last[bar] = phase
            slot = (slot + 2) % K_STAGES
            visits += 1
            if visits == K_STAGES:
                visits, parity = 0, parity ^ 1


def test_one_barrier_a_slot_skips_the_other_warpgroups_phase():
    """The scheme before: a warpgroup's next wait on a slot is two phases
    after its last, so the phase between (the other warpgroup's) can still
    be open when it looks, and its parity then reads as done."""
    for wg, seq in phases(True, 18, 8).items():
        last, skips, parity, slot = {}, 0, 0, wg
        for bar, phase in seq:
            assert bar == slot and parity == phase & 1  # SSTTS_SHARED_FULL's parity
            if bar in last:
                assert phase - last[bar] in (1, 2)
                skips += phase - last[bar] == 2
            last[bar] = phase
            slot += 2
            if slot >= K_STAGES:
                slot, parity = slot - K_STAGES, parity ^ 1
        assert skips > 0


@pytest.mark.parametrize("n_kc,n_pairs", [(3, 2), (18, 8), (33, 4), (2, 3)])
def test_the_stress_order_waits_on_no_later_stage(n_kc, n_pairs):
    """Each pair's stages in a new order, and none waits on a stage issued
    after it: stage n's slot is free once stage n - kStages is released,
    which its warpgroup does after taking its next stage, or at once if
    that was its last of the pair."""
    n_stages = 2 * n_kc * n_pairs
    order = stress_order(n_stages, n_kc)
    assert sorted(order) == list(range(n_stages))
    issued = {}
    for pos, n in enumerate(order):
        issued[n] = pos
    for n in range(n_stages):
        prev = n - K_STAGES
        if prev < 0:
            continue
        m = prev >> 1
        last_of_pair = m % n_kc == n_kc - 1
        needs = [prev] if last_of_pair else [prev, prev + 2]
        assert all(issued[d] < issued[n] for d in needs), (n, needs)
