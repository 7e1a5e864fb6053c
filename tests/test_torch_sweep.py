"""The CUDA sweep's module (``wafer_torch/ops/hopper_stencil.py``) against
the reference's Pallas kernels, run as tests/test_pallas_stencil.py runs
them on the CPU (interpret mode).

On CPU tensors the wrappers take their plain torch versions, so these
tests hold the plain versions — the oracle chip_smoke.py and
tests/test_torch_gpu.py compare the kernels with on the card — against
Pallas.

Tolerance: 1e-5 of the reference field's largest magnitude (f32; the
port corrects every tap where the resident TPU kernel corrects the swept
images, and sums in f64 where the TPU sums in f32)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import base_config
from wafer_torch import convert
from wafer_torch.ops import hopper_stencil as hs
from wafer_tpu import geometry as jgeo
from wafer_tpu.models import potentials as jpot
from wafer_tpu.ops import pallas_stencil as pk

ORDERS = ["ThreePoint", "FivePoint", "SevenPoint"]
KINDS = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic"]
RTOL = 1e-5


def close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= rtol * np.abs(ref).max(), err / np.abs(ref).max()


def _setup(order, potential="Harmonic", n=(16, 16, 16), seed=0, **kw):
    cfg = base_config(
        central_difference=order, precision="f32", potential=potential,
        grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.2, "dt": 0.004}, **kw,
    )
    ext = cfg.central_difference.ext
    g = cfg.grid
    phi = np.pad(np.random.default_rng(seed).normal(size=n), ext).astype(np.float32)
    v = jpot.generate(cfg).astype(jnp.float32)
    _a, b = jpot.build_ab(v, g.dt)
    b_int = np.asarray(jgeo.work_area(b, ext))
    analytic = (potential, g.dn, g.dt, cfg.mass, *n, cfg.sig)
    _o, _c, _cc, k = jgeo.stencil_coefficients(order)
    scale = g.dt / (k * g.dn ** 2 * cfg.mass)
    return cfg, ext, phi, b_int, analytic, scale


def _lowers(cfg, n_lower, seed):
    rng = np.random.default_rng(seed)
    ext = cfg.central_difference.ext
    out = []
    for _ in range(n_lower):
        w = np.pad(rng.normal(size=cfg.work_size()), ext)
        out.append((w / np.sqrt(np.sum(w * w))).astype(np.float32))
    return np.stack(out)


def _xpad(a, ext):
    """Fully padded → the reference's x-padded layout (leading axes kept)."""
    return jnp.asarray(a[..., ext:-ext, ext:-ext])


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1"])
@pytest.mark.parametrize("b_mode", ["analytic", "streamed"])
@pytest.mark.parametrize("order", ORDERS)
def test_step_matches_pallas(order, b_mode, mode):
    """One sweep with a non-identity carried coefficient vs
    ``pallas_stencil.evolve_step_fused`` (B2): ψ' and its reductions."""
    cfg, ext, phi, b_int, analytic, scale = _setup(order)
    n_lower = 1 if mode == "S1" else 0
    with_norm = mode != "ground"
    store = _lowers(cfg, n_lower, 1) if n_lower else None
    coef = np.array([[0.8], [0.3]], np.float32)[: 1 + n_lower] if with_norm else None
    an = analytic if b_mode == "analytic" else None
    out_j, n2_j, ov_j = pk.evolve_step_fused(
        _xpad(phi, ext), None if an else jnp.asarray(b_int),
        None if store is None else _xpad(store, ext), order, scale, n_lower, with_norm,
        interpret=True, coef=None if coef is None else jnp.asarray(coef), analytic=an,
    )
    psi = convert.tensor(phi)
    out_t = torch.empty_like(psi)
    coef_t = convert.tensor(coef).reshape(-1) if with_norm else torch.ones(1)
    part = torch.empty(1, 1 + n_lower, dtype=torch.float64) if with_norm else None
    hs.sweep_step(
        psi, out_t, coef_t, part, order=order, scale=scale, analytic=an,
        b_int=None if an else convert.tensor(b_int),
        store=None if store is None else convert.tensor(store), apply_coef=with_norm,
    )
    close(out_t, pk.from_xpad(out_j, ext))
    if with_norm:
        red = torch.empty(1 + n_lower, dtype=torch.float64)
        hs.finish_coef(part, red, torch.empty_like(coef_t))
        n2 = float(n2_j)
        assert abs(float(red[0]) - n2) <= RTOL * n2
        if n_lower:
            assert abs(float(red[1]) - float(ov_j[0])) <= RTOL * np.sqrt(n2)


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_b_matches_pallas(kind):
    """B from coordinates (with a gauge shift) vs ``_analytic_b``, and vs
    the array B the reference builds from the generated V."""
    n, ext, vshift = (12, 10, 14), 2, 1.7
    cfg = base_config(
        central_difference="FivePoint", precision="f32", potential=kind, mass=4.65, sig=0.223,
        grid={"size": {"x": n[0], "y": n[1], "z": n[2]}, "dn": 0.35, "dt": 0.004},
    )
    analytic = (kind, 0.35, 0.004, 4.65, *n, 0.223, vshift)
    out = hs.analytic_b(analytic, cfg.padded_size(), ext)
    assert out.dtype == torch.float32 and tuple(out.shape) == n
    close(out, pk._analytic_b(analytic, n, float(ext), ext, ext), 1e-6)
    _a, b = jpot.build_ab(jpot.generate(cfg), 0.004, v_shift=vshift)
    close(out, jgeo.work_area(b, ext), 2e-5)


CHUNK_CASES = [
    ("ThreePoint", "ground", "analytic"),
    ("FivePoint", "ground", "analytic"),
    ("SevenPoint", "ground", "analytic"),
    ("ThreePoint", "per_step_norm", "analytic"),
    ("ThreePoint", "S1", "analytic"),
    ("ThreePoint", "S2", "analytic"),
    ("SevenPoint", "S1", "analytic"),
    ("ThreePoint", "ground", "streamed"),
    ("ThreePoint", "per_step_norm", "streamed"),
    ("FivePoint", "S1", "streamed"),
    # three and four stored states: K1's many-state kernels on the card
    ("ThreePoint", "S3", "analytic"),
    ("ThreePoint", "S4", "analytic"),
    ("SevenPoint", "S3", "analytic"),
    ("SevenPoint", "S4", "analytic"),
    ("FivePoint", "S3", "streamed"),
    ("FivePoint", "S4", "streamed"),
    # five and six stored states: the wide route (stencil_sweep_wide.cu) on the card
    ("ThreePoint", "S5", "analytic"),
    ("SevenPoint", "S6", "analytic"),
    ("FivePoint", "S5", "streamed"),
    ("ThreePoint", "S6", "streamed"),
]
N_LOWER = {"S1": 1, "S2": 2, "S3": 3, "S4": 4, "S5": 5, "S6": 6}


@pytest.mark.parametrize("order, mode, b_mode", CHUNK_CASES)
def test_chunk_matches_pallas_resident(order, mode, b_mode):
    """A 5-step chunk vs ``evolve_chunk_resident`` (B1 ground and
    per-step-norm, B3 excited with the l/S(l) streams)."""
    cfg, ext, phi, b_int, analytic, scale = _setup(order, seed=2)
    g = cfg.grid
    n_lower = N_LOWER.get(mode, 0)
    psn = mode == "per_step_norm"
    an = analytic if b_mode == "analytic" else None
    bj = None if an else jnp.asarray(b_int)
    kw = {}
    store = None
    if n_lower:
        store = _lowers(cfg, n_lower, 3)
        sls = [
            pk.evolve_step_fused(_xpad(w, ext), bj, None, order, scale, 0, False,
                                 interpret=True, analytic=an)[0]
            for w in store
        ]
        kw = dict(store_xpad=_xpad(store, ext), sstore_xpad=jnp.stack(sls))
    ref = pk.evolve_chunk_resident(
        _xpad(phi, ext), order, g.dt, g.dn, cfg.mass, 5, an, interpret=True,
        per_step_norm=psn, b_int=bj, **kw,
    )
    out = hs.evolve_chunk(
        convert.tensor(phi), order, g.dt, g.dn, cfg.mass, 5, an, per_step_norm=psn,
        store=None if store is None else convert.tensor(store),
        b_int=None if an else convert.tensor(b_int),
    )
    close(out, pk.from_xpad(ref, ext))


@pytest.mark.parametrize("mode", ["ground", "per_step_norm", "S1", "S2", "S3"])
def test_chunk_matches_pallas_fused(mode):
    """The same chunk function vs ``evolve_chunk_fused`` (B2's chunk: the
    correction applied to the input taps, as the CUDA kernel does)."""
    order = "FivePoint"
    cfg, ext, phi, b_int, analytic, scale = _setup(order, seed=4)
    g = cfg.grid
    n_lower = N_LOWER.get(mode, 0)
    psn = mode == "per_step_norm"
    store = _lowers(cfg, n_lower, 5) if n_lower else None
    ref = pk.evolve_chunk_fused(
        _xpad(phi, ext), jnp.asarray(b_int), None if store is None else _xpad(store, ext),
        order, g.dt, g.dn, cfg.mass, 4, n_lower, interpret=True, per_step_norm=psn,
    )
    out = hs.evolve_chunk(
        convert.tensor(phi), order, g.dt, g.dn, cfg.mass, 4, per_step_norm=psn,
        store=None if store is None else convert.tensor(store), b_int=convert.tensor(b_int),
    )
    close(out, pk.from_xpad(ref, ext))


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors run the plain versions and launch (count) nothing."""
    cfg, ext, phi, _b, analytic, scale = _setup("ThreePoint", seed=6)
    psi = convert.tensor(phi)
    store = convert.tensor(_lowers(cfg, 2, 7))
    coef = torch.tensor([0.9, 0.2, -0.1])
    before = dict(hs.LAUNCHES)
    assert hs.num_partials(psi, "ThreePoint") == 1
    kw = dict(order="ThreePoint", scale=scale, analytic=analytic, store=store, apply_coef=True)
    out, ref = torch.empty_like(psi), torch.empty_like(psi)
    part, part_ref = torch.empty(1, 3, dtype=torch.float64), torch.empty(1, 3, dtype=torch.float64)
    hs.sweep_step(psi, out, coef, part, **kw)
    hs.sweep_step_plain(psi, ref, coef, part_ref, **kw)
    assert torch.equal(out, ref) and torch.equal(part, part_ref)
    red, c = torch.empty(3, dtype=torch.float64), torch.empty(3)
    hs.finish_coef(part, red, c)
    assert float(c[0]) == pytest.approx(float(red[0]) ** -0.5, rel=1e-6)
    assert float(c[2]) == pytest.approx(float(red[2]) * float(c[0]), rel=1e-6)
    assert hs.LAUNCHES == before
    # the shell is written zero, the input is untouched
    assert float(out[0].abs().max()) == 0.0 and torch.equal(psi, convert.tensor(phi))


def test_wrappers_reject_other_devices():
    psi = torch.empty(6, 6, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hs.sweep_step(psi, torch.empty_like(psi), torch.ones(1, device="meta"), None,
                      order="ThreePoint", scale=0.1, analytic=("Harmonic", 0.2, 0.004, 1.0, 4, 4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        hs.finish_coef(torch.empty(1, 1, device="meta"), torch.empty(1, device="meta"),
                       torch.empty(1, device="meta"))


@pytest.mark.parametrize("n_red", range(1, 8))
def test_finish_coef_plain_at_odd_row_counts(n_red):
    """K2's plain path (its CPU path and the yardstick on the card) on row
    counts that fill no group evenly: the column sums in f64 against numpy's
    and coef = [rsqrt(max(red₀, 1e-37)), red_q·inv] in f32; the bound
    launcher gives the same and launches (counts) nothing."""
    rng = np.random.default_rng(n_red)
    before = dict(hs.LAUNCHES)
    for rows in (1, 7, 1001):
        x = rng.normal(size=(rows, n_red))
        x[:, 0] = np.abs(x[:, 0])
        part = torch.from_numpy(x)
        red, coef = torch.empty(n_red, dtype=torch.float64), torch.empty(n_red)
        hs.finish_coef(part, red, coef)
        want = x.sum(axis=0)
        np.testing.assert_allclose(red.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(x).sum())
        inv = 1.0 / np.sqrt(max(want[0], 1e-37))
        np.testing.assert_allclose(coef.numpy(), np.float32(np.r_[inv, want[1:] * inv]),
                                   rtol=1e-6, atol=1e-6 * inv * np.abs(x).sum())
        red2, coef2 = torch.empty_like(red), torch.empty_like(coef)
        hs.finish_launcher(part, red2, coef2)()
        assert torch.equal(red, red2) and torch.equal(coef, coef2)
    assert hs.LAUNCHES == before


@pytest.mark.parametrize("n_blocks, n_red", [(1, 1), (7, 5), (2048, 2), (4096, 3), (4097, 2),
                                              (16384, 2), (16384, 3), (32768, 7), (100003, 3),
                                              (300001, 1), (2048, 1), (16384, 1), (16385, 1),
                                              (8192, 2), (5462, 3)])
def test_finish_groups_and_scratch(n_blocks, n_red):
    """K2's launch shape: one block up to FINISH_ONE_BLOCK doubles (rows ×
    columns), then a group for about every FINISH_GROUP rows, at most
    FINISH_MAX_GROUPS, so that every group has rows to add."""
    groups = hs.finish_groups(n_blocks, n_red)
    assert 1 <= groups <= min(n_blocks, hs.FINISH_MAX_GROUPS)
    assert (groups == 1) == (n_blocks * n_red <= hs.FINISH_ONE_BLOCK)
    if 1 < groups < hs.FINISH_MAX_GROUPS:
        assert (groups - 1) * hs.FINISH_GROUP < n_blocks <= groups * hs.FINISH_GROUP
    per = -(-n_blocks // groups)
    assert (groups - 1) * per < n_blocks  # the last group starts inside the rows


def test_finish_coef_checks_its_scratch():
    """The launcher makes K2's scratch itself, so no caller passes one; its
    arguments are checked as the other wrappers' are, on the CPU as on the
    card, and the CPU launcher holds the tensors it runs on."""
    part = torch.ones(5, 3, dtype=torch.float64)
    red, coef = torch.empty(3, dtype=torch.float64), torch.empty(3)
    with pytest.raises(TypeError):
        hs.finish_coef(part, red, coef, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="red: expected"):
        hs.finish_launcher(part, red[:2], coef)
    with pytest.raises(ValueError, match="coef: expected"):
        hs.finish_launcher(part, red, coef.double())
    with pytest.raises(ValueError, match="partials must be"):
        hs.finish_launcher(part[0], red, coef)
    launch = hs.finish_launcher(part, red, coef)
    del part
    launch()
    assert red.tolist() == [5.0, 5.0, 5.0]


def test_chunk_requires_a_b_source():
    with pytest.raises(ValueError, match="analytic or b_int"):
        hs.evolve_chunk(torch.zeros(6, 6, 6), "ThreePoint", 0.004, 0.2, 1.0, 2)


CSRC = Path(__file__).resolve().parent.parent / "wafer_torch" / "csrc"
SWEEP_SOURCES = ["stencil_sweep.cu", "stencil_sweep_bf16.cu", "stencil_sweep_many.cu",
                 "stencil_sweep_wide.cu", "split_sweep.cu"]


@pytest.mark.parametrize("source", SWEEP_SOURCES)
def test_no_sweep_source_defines_the_launch_shape(source):
    """The launch shape every route of K1 and K3 launches (16-row tiles,
    segments of up to 16 planes), and so the partial rows that
    wafer_sweep_num_blocks counts for all of them, is defined once, in
    sweep_common.cuh: no sweep source defines its own segment, tile-row
    count or grid, and each holds its own thread shape (kTileY thread rows
    of kRows tile rows) to the shared tile at compile time."""
    text = (CSRC / source).read_text()
    assert not re.search(r"constexpr int (kSegment|kTileRows|kFillBlocks)\b", text)
    assert not re.search(r"\b(march_grid|march_segment)\s*<", text)
    assert "static_assert(kTileY * kRows == kTileRows," in text
    common = (CSRC / "sweep_common.cuh").read_text()
    assert re.search(r"constexpr int kTileRows = 16;", common)
    assert re.search(r"constexpr int kSegment = 16;", common)


@pytest.mark.parametrize("source", SWEEP_SOURCES)
def test_every_route_launches_the_shared_grid(source):
    """Every kernel launch of a sweep source takes the shared grid
    (sweep_grid), and the source's route launchers are the ones the shared
    header declares, which launch_route picks by sweep_route's code."""
    text = (CSRC / source).read_text()
    grids = re.findall(r"<<<\s*([^,]+),", text)
    assert grids and set(grids) <= {"sweep_grid(a)", "grid"}
    if "grid" in grids:
        assert "const dim3 grid = sweep_grid(a);" in text
    common = (CSRC / "sweep_common.cuh").read_text()
    launchers = re.findall(r"^int (launch_k\w+)\(const SweepArgs& a, int ext, cudaStream_t s\)",
                           text, re.M)
    assert launchers
    for name in launchers:
        assert re.search(rf"int {name}\(const SweepArgs&, int, cudaStream_t\);", common)
        assert re.search(rf"\b{name}\b", common[common.index("inline int launch_route("):])


def _library_route(pair, n_store, store_bf16):
    """csrc/sweep_common.cuh's sweep_route, by its codes."""
    if n_store < 0 or (pair and store_bf16):
        return -1
    if pair:
        return 7 if n_store >= 3 else 6
    return (4 if n_store > 4 else 2 if n_store >= 3 else 0) + int(bool(store_bf16) and n_store > 0)


@pytest.fixture
def library_routes(monkeypatch):
    """hopper_stencil.route on a library whose wafer_sweep_route is the
    header's rule (the card's library gives the same codes: the gpu
    tests' launches count under them)."""
    from wafer_torch.ops import _build

    class Library:
        @staticmethod
        def wafer_sweep_route(pair, n_store, store_bf16):
            return _library_route(pair, n_store, store_bf16)

    hs.route.cache_clear()
    monkeypatch.setattr(_build, "library", lambda: Library)
    yield hs.route
    hs.route.cache_clear()


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("n_store", range(10))
def test_k1_launch_counts_under_the_key_of_its_route(library_routes, n_store, stream):
    """K1's LAUNCHES key comes from the route table indexed by the
    library's route: the key the rule before the route export gave
    (bf16 stores only with stored states, the many-state kernels at 3
    and 4, the wide route from 5)."""
    bf16 = stream == "bf16" and n_store > 0
    want = ("sweep_step_bf16" if bf16 else "sweep_step") + (
        "_many" if n_store in (3, 4) else "_wide" if n_store >= 5 else "")
    assert library_routes(False, n_store, stream == "bf16") == want
    assert want in hs.LAUNCHES


@pytest.mark.parametrize("n_store", range(6))
def test_k3_launch_counts_under_the_key_of_its_route(library_routes, n_store):
    """K3's LAUNCHES key: its wide route from three stored pairs."""
    want = "sweep_step_sc_wide" if n_store >= 3 else "sweep_step_sc"
    assert library_routes(True, n_store, False) == want
    assert want in hs.LAUNCHES


@pytest.mark.parametrize("pair, n_store, bf16", [(False, -1, False), (True, 1, True)])
def test_a_launch_without_a_route_raises(library_routes, pair, n_store, bf16):
    """The library's no-route code (a negative count, a pair on a bf16
    store) names no counter: route raises, not a wrapped index."""
    with pytest.raises(ValueError, match="no route"):
        library_routes(pair, n_store, bf16)


def test_row_copies_are_counted_apart_from_launches():
    """ROW_COPIES counts the costly bf16 launches by their psi row copies'
    width, apart from LAUNCHES (which counts kernels, and whose keys and
    sum the card's tests compare whole); reset_launches zeroes both."""
    assert set(hs.ROW_COPIES) == {"8", "4"}
    assert not set(hs.ROW_COPIES) & set(hs.LAUNCHES)
    saved = dict(hs.LAUNCHES), dict(hs.ROW_COPIES)
    try:
        hs.ROW_COPIES.update({"8": 3, "4": 1})
        hs.LAUNCHES["sweep_step_bf16"] += 2
        hs.reset_launches()
        assert hs.ROW_COPIES == {"8": 0, "4": 0}
        assert not any(hs.LAUNCHES.values())
    finally:
        hs.LAUNCHES.update(saved[0])
        hs.ROW_COPIES.update(saved[1])


@pytest.mark.parametrize("kind", ["Coulomb", "SimpleCornell", "Periodic"])
def test_costly_bf16_sweep_on_cpu_counts_no_row_copies(kind):
    """On CPU tensors a costly kind's sweep on a bf16 store runs the plain
    version, which copies no rows and counts nothing."""
    cfg, _ext, phi, _b, _an, scale = _setup("ThreePoint", potential=kind, n=(6, 8, 7), seed=9)
    psi = convert.tensor(phi)
    store = convert.tensor(_lowers(cfg, 2, 10)).to(torch.bfloat16)
    before = dict(hs.ROW_COPIES), dict(hs.LAUNCHES)
    out = torch.empty_like(psi)
    hs.sweep_step(psi, out, torch.tensor([0.9, 0.2, -0.1]), torch.empty(1, 3, dtype=torch.float64),
                  order="ThreePoint", scale=scale, analytic=(kind, 0.2, 0.004, 1.0, 6, 8, 7, 1.0),
                  store=store, apply_coef=True)
    assert (dict(hs.ROW_COPIES), dict(hs.LAUNCHES)) == before
