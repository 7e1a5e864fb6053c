"""``chip_smoke.py``'s bounds on the CPU: the least work of a sweep, K2's
work over its partial rows, and the script's refusal to run without a card.

A sweep's bound is the work any implementation must do (ψ read and ψ'
written once over the padded volume, streamed B once, each stored state
once), so it is a closed form of the grid and holds no term of the kernels'
launch shape; K2's bound grows with the rows the sweep's launch wrote."""

import math

import pytest

import chip_smoke as cs

SHAPES = [(256, 256, 256), (37, 45, 29), (64, 8, 200)]


def closed_form_bytes(n, ext, n_store, streamed, pair):
    comps = 2 if pair else 1
    padded = math.prod(d + 2 * ext for d in n)
    return 4 * comps * (padded * (2 + n_store) + math.prod(n) * streamed)


@pytest.mark.parametrize("n_store", [0, 1, 2])
@pytest.mark.parametrize("ext", [1, 2, 3])
@pytest.mark.parametrize("n", SHAPES, ids=["256", "odd", "flat"])
def test_sweep_bytes_are_the_closed_form(n, ext, n_store):
    for pair in (False, True):
        for streamed in (False, True):
            want = closed_form_bytes(n, ext, n_store, streamed, pair)
            for reduce in (False, True):
                # the reductions add operations, never bytes: no partial rows
                assert cs.sweep_work(n, ext, n_store, streamed, reduce, pair)[0] == want


@pytest.mark.parametrize("n_store", [1, 2, 3])
@pytest.mark.parametrize("n", SHAPES, ids=["256", "odd", "flat"])
def test_bf16_streams_count_two_bytes_a_stored_value(n, n_store):
    """K1's bf16 stored-state streams: each stored state's padded volume at
    2 bytes a value, ψ, ψ' and a streamed B as before; the operations do not
    change."""
    padded = math.prod(d + 2 for d in n)
    for streamed in (False, True):
        f32 = cs.sweep_work(n, 1, n_store, streamed, True)
        bf16 = cs.sweep_work(n, 1, n_store, streamed, True, stream_bytes=2)
        assert f32[0] - bf16[0] == 2 * padded * n_store and f32[1] == bf16[1]


def test_bf16_step_bounds():
    """The same-work bounds of a K1 step with 2-byte stored states: 256³
    S = 1 and 512³ S = 1 and 2 (ms, 3.35 TB/s)."""
    for n, n_store, want in ((256, 1, 0.0513), (512, 1, 0.4054), (512, 2, 0.4864)):
        got = cs.bound(cs.sweep_work((n,) * 3, 1, n_store, reduce=True, stream_bytes=2))
        assert got[1] == "bytes" and got[0] == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("pair", [False, True], ids=["K1", "K3"])
def test_sweep_work_has_no_launch_shape_term(pair):
    """The work of a grid is the sum of the work of its parts' interiors
    plus their halos, whatever tiles a kernel cuts it into: shifting a
    grid's extents by one point moves the bytes by exactly the closed form."""
    for n in SHAPES:
        for grow in range(3):
            m = (n[0], n[1], n[2] + 31 * grow)  # crosses 32-wide tile edges
            assert cs.sweep_work(m, 1, 1, True, True, pair)[0] == closed_form_bytes(
                m, 1, 1, True, pair)


def test_sweep_operations_count_the_correction_once():
    """The correction is charged once per padded point, not per tap: the
    excited sweep's operations exceed the ground sweep's by the correction
    and the overlaps alone, at every order."""
    n = (37, 45, 29)
    for ext in (1, 2, 3):
        padded = math.prod(d + 2 * ext for d in n)
        interior = math.prod(n)
        ground = cs.sweep_work(n, ext)[1]
        excited = cs.sweep_work(n, ext, n_store=2, reduce=True)[1]
        assert excited - ground == (1 + 2 * 2) * padded + 2 * (1 + 2) * interior


@pytest.mark.parametrize("n_red", [1, 2, 3, 5])
def test_k2_bound_scales_with_its_rows(n_red):
    base = cs.finish_work(0, n_red)
    for rows in (1, 2048, 16384, 567970):
        nbytes, flops = cs.finish_work(rows, n_red)
        assert nbytes - base[0] == 8 * rows * n_red
        assert flops - base[1] == rows * n_red


def test_step_bound_adds_k2_over_the_rows_given():
    n = (512, 512, 512)
    sweep = cs.bound(cs.sweep_work(n, 1, 1, reduce=True))[0]
    assert cs.step_bound_ms(n, 1, reduce=True, rows=0) == pytest.approx(
        cs.bound((cs.sweep_work(n, 1, 1, reduce=True)[0] + 24, 0))[0])
    for rows in (16384, 567970):
        extra = cs.step_bound_ms(n, 1, reduce=True, rows=rows) - sweep
        assert extra == pytest.approx((8 * rows * 2 + 24) / cs.HBM_BYTES_PER_S * 1e3)
    # a ground step runs no K2: its rows do not count
    assert cs.step_bound_ms(n, rows=16384) == cs.bound(cs.sweep_work(n, 1))[0]


def test_bound_takes_the_larger_time():
    assert cs.bound((3.35e9, 0)) == (pytest.approx(1.0), "bytes")
    assert cs.bound((0, 67e9)) == (pytest.approx(1.0), "operations")
    assert cs.bound(cs.sweep_work((256, 256, 256), 1))[1] == "bytes"


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "is_available() is false" in out.err
