"""The hand-written CUDA sweep (``csrc/stencil_sweep.cu``; on a bf16 store
``csrc/stencil_sweep_bf16.cu``; with three or four stored states
``csrc/stencil_sweep_many.cu``, with more ``csrc/stencil_sweep_wide.cu``)
bound to torch — the Hopper counterpart of
``wafer_tpu/ops/pallas_stencil.py``.

Two kernels, each with a plain torch version of the same function in this
module and a launch counter (:data:`LAUNCHES`):

- :func:`sweep_step` (K1) replaces ``pallas_stencil._evolve_kernel`` (B2)
  and, looped with K2, ``_evolve_kernel_res`` (B1 ground/per-step-norm,
  B3 excited) and the large-grid kernels ``_evolve_kernel_k`` (B5),
  ``_evolve_kernel_resb`` (B6) and ``_evolve_kernel_kgs`` (B4): one sweep
  ψ' = B·(2c + scale·L(c)) − c of the corrected input
  c = inv·ψ − Σₛ corrₛ·lₛ, with a zero Dirichlet shell, writing per-block
  partials of ‖ψ'‖² and ⟨lₛ|ψ'⟩.
- :func:`finish_coef` (K2, ``csrc/finish_coef.cu``) adds the partials in a
  fixed order in f64 and writes the reductions and the next step's
  coefficients ``[rsqrt(max(n², 1e-37)), ovₛ·inv]`` to device memory.
  A chunk binds it once with :func:`finish_launcher`, which owns K2's
  scratch, so a step pays the launch and not the checks.

Given a shard block of a device mesh and its ``origin`` in the global grid
(``parallel/sharded.py``), K1 reads the analytic B at global coordinates, so
a block computes each point exactly as the whole grid does: the sharded
modes of B1–B6 and the mesh-only kernels B12–B14. Its ``partials`` may be a
row range of one buffer that K2 then adds over every shard.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. :func:`evolve_chunk` runs a whole
``screen_update`` chunk on the device with no host synchronisation.

Layout: the fully padded ``(N+2e)³`` arrays of the rest of the package
(the reference's x-padded layout exists only for TPU tiling). Stored-state
streams are f32 or, by the reference's rule (:func:`exc_stream_dtype`), bf16:
K1 then reads 2 bytes a point of each lₛ and upcasts it to f32.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, Optional

import torch

from wafer_torch import chunk_graph, geometry
from wafer_torch.config import Config, PotentialType
from wafer_torch.errors import KernelLaunchError
from wafer_torch.ops import _build
from wafer_torch.ops.stencil import shifted

# analytic-B potential kinds; codes match csrc/stencil_sweep.cu ``Kind``
KINDS = {"NoPotential": 0, "Harmonic": 1, "Coulomb": 2, "SimpleCornell": 3, "Periodic": 4}
_STREAMED = -1
# the potentials whose B the sweeps compute from coordinates; a complex
# potential looks up its real counterpart (Harmonic and Coulomb, the kinds
# of hopper_split.KINDS; FullCornell streams its B)
_FORMULA = {
    PotentialType.NO_POTENTIAL: "NoPotential",
    PotentialType.HARMONIC: "Harmonic",
    PotentialType.COULOMB: "Coulomb",
    PotentialType.SIMPLE_CORNELL: "SimpleCornell",
    PotentialType.PERIODIC: "Periodic",
}

# launches of the kernel library's kernels (K1, K2 here, K3 in hopper_split)
# since the last reset_launches(); plain versions never count, and a CUDA
# graph's replay counts the launches its capture made (batch.BatchRunner).
# A K1 or K3 launch counts under the name of its route (:func:`route`).
LAUNCHES = {"sweep_step": 0, "finish_coef": 0, "sweep_step_sc": 0, "sweep_step_bf16": 0,
            "sweep_step_many": 0, "sweep_step_bf16_many": 0, "sweep_step_wide": 0,
            "sweep_step_bf16_wide": 0, "sweep_step_sc_wide": 0}

# The names of K1's and K3's routes, by the library's code for each
# (csrc/sweep_common.cuh, sweep_route).
ROUTES = ("sweep_step", "sweep_step_bf16", "sweep_step_many", "sweep_step_bf16_many",
          "sweep_step_wide", "sweep_step_bf16_wide", "sweep_step_sc", "sweep_step_sc_wide")


# K1's launches on the costly kinds' bf16 sweep (Coulomb, SimpleCornell or
# Periodic B, one or two bf16 stored states) by the width of its psi row
# copies in bytes (csrc/stencil_sweep_bf16.cu, wafer_sweep_row_copy_bytes):
# "8" where every row of a tile starts 8-byte aligned, "4" else. Counted
# when a launcher runs (a CUDA graph's replay adds nothing); apart from
# LAUNCHES, which counts kernels.
ROW_COPIES = {"8": 0, "4": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROW_COPIES):
        for name in counts:
            counts[name] = 0


@functools.lru_cache(maxsize=None)
def route(pair: bool, n_store: int, bf16: bool) -> str:
    """The :data:`LAUNCHES` key of a K1 (``pair``: K3) launch with
    ``n_store`` stored states on a bf16 store or not: the library's one
    route rule (``wafer_sweep_route``)."""
    code = _build.library().wafer_sweep_route(int(pair), n_store, int(bf16))
    if not 0 <= code < len(ROUTES):
        raise ValueError(f"no route for {n_store} stored states (pair {pair}, bf16 {bf16})")
    return ROUTES[code]


def many_states() -> range:
    """The stored-state counts K1 launches on its many-state kernels
    (``csrc/stencil_sweep_many.cu``: three up to a compile-time most); K1
    takes fewer on the kernels of each count, more on its wide route."""
    return range(3, _build.library().wafer_sweep_many_max() + 1)


def wide_min(pair: bool = False) -> int:
    """The fewest stored states K1 (``pair``: stored pairs K3) launches on
    its wide route (``csrc/stencil_sweep_wide.cu``), which takes every
    count from there on: the states past those its rings of shared memory
    hold (:func:`wide_layout`) are read where they are used."""
    return _build.library().wafer_sweep_wide_min(int(pair))


def wide_layout(pair: bool, bf16: bool, ext: int, n_store: int,
                streamed: bool = False) -> tuple[int, int, int]:
    """(blocks an SM, dynamic shared bytes, stored states in its rings) of
    the wide route's launch at EXT ``ext`` with ``n_store`` stored states
    (``pair``: K3's; else K1's, ``bf16`` on a bf16 store), B ``streamed``
    or from coordinates, on the current card; raises on a CUDA error."""
    nbytes, ring = ctypes.c_int(), ctypes.c_int()
    blocks = _build.library().wafer_sweep_wide_occupancy(
        int(pair), int(bf16), ext, n_store, int(streamed), ctypes.byref(nbytes),
        ctypes.byref(ring))
    _raise_if_failed("wafer_sweep_wide_occupancy", -blocks if blocks < 0 else 0)
    return blocks, nbytes.value, ring.value


def exc_stream_dtype(config: Config, n_lower: int, kernel: bool,
                     mesh_shape=(1, 1, 1)) -> torch.dtype:
    """The dtype a solve's chunks stream its stored lower states in — the
    reference's rule (wafer_tpu/solver.py:517-535 on one device,
    wafer_tpu/parallel/sharded.py:359-369 on a mesh). ``torch.bfloat16``
    when ``WAFER_EXC_STREAM`` (default ``"bf16"``) is ``"bf16"``, the state
    has stored states (``n_lower`` ≥ 1), ψ is real f32 on the kernel route
    (``kernel``: ``solver._resolve_backend`` gives ``"kernel"``, or a mesh's
    ``use_pallas``), the mesh (``mesh_shape``, the whole mesh; one device by
    default) shards one axis at most, and the second axis of the
    reference's layout is a multiple of 16 (its bf16 sublane tiling; y on
    one device, on a mesh the first unsharded axis, as the reference moves
    the sharded axis first). Else the run's own precision (f32, or f64 on
    the plain route): pairs, f64, the plain route, meshes sharded on two or
    three axes (the reference's XLA and y/z-padded routes) and
    ``WAFER_EXC_STREAM=f32``. The reference's TPU budget gates
    (its VMEM pickers ``resident_exc_supported`` and ``_pick_tx_res_exc``,
    and the lane tiling of sharded.py:106-125) are not ported: they
    describe the TPU's memory, not this card's."""
    own = config.real_dtype
    if (os.environ.get("WAFER_EXC_STREAM", "bf16") != "bf16" or n_lower < 1 or not kernel
            or config.potential.is_complex or own != torch.float32
            or sum(m > 1 for m in mesh_shape) > 1):
        return own
    layout = sorted(range(3), key=lambda axis: -mesh_shape[axis])
    return torch.bfloat16 if config.work_size()[layout[1]] % 16 == 0 else own


def analytic_params(config: Config, v_shift: float):
    """The reference's analytic tuple (kind, dn, dt, mass, nx, ny, nz, sig,
    v_shift[, absorb]) for a potential whose B the sweeps compute from
    coordinates (absorb for a complex one), or None when B is streamed.
    ``v_shift`` is the gauge shift baked into the arrays A and B."""
    split = config.potential.is_complex
    kind = _FORMULA.get(config.potential.real_counterpart if split else config.potential)
    if kind is None:
        return None
    g = config.grid
    return (
        kind, g.dn, g.dt, config.mass, g.size.x, g.size.y, g.size.z, config.sig, v_shift,
    ) + ((config.absorb,) if split else ())


# --------------------------------------------------------------------------- #
# plain torch versions
# --------------------------------------------------------------------------- #


def analytic_v(analytic, shape, ext: int, device=None, origin=(0, 0, 0)) -> torch.Tensor:
    """Interior raw V (no gauge shift) in f32 from padded-index coordinates —
    ``pallas_stencil._analytic_v`` and the kernels' ``analytic_v``.
    ``analytic`` = (kind, dn, dt, mass, ngx, ngy, ngz[, sig, …]) with the
    global extents ng; ``shape`` is the padded shape of the block whose
    interior starts at ``origin`` in the global interior (the whole grid at
    the zero origin)."""
    kind, dn, _dt, mass = analytic[:4]
    ng = analytic[4:7]
    sig = float(analytic[7]) if len(analytic) > 7 else 0.0
    f32 = torch.float32
    axes = [
        torch.arange(ext + o, n - ext + o, dtype=f32, device=device).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        for ax, (n, o) in enumerate(zip(shape, origin))
    ]
    if kind == "Periodic":
        two_pi = 2.0 * 3.14159265358979323846
        s = [torch.sin(two_pi * (x - 1.0) / (g - 1.0)) ** 2 for x, g in zip(axes, ng)]
        return 1.0 - s[0] * (s[1] * s[2])
    d = [x - (g + 1.0) / 2.0 for x, g in zip(axes, ng)]
    r2 = d[0] * d[0] + (d[1] * d[1] + d[2] * d[2])
    if kind == "Harmonic":
        return (0.5 * dn * dn) * r2
    if kind in ("Coulomb", "SimpleCornell"):
        r = dn * torch.sqrt(r2)
        rs = torch.clamp(r, min=dn)
        if kind == "Coulomb":
            return torch.where(r < dn, -1.0 / dn, -1.0 / rs)
        far = (-0.5 * (4.0 / 3.0) / rs + sig * rs) + 4.0 * mass
        return torch.where(r < dn, 4.0 * mass, far)
    if kind == "NoPotential":
        return torch.zeros_like(r2)
    raise ValueError(f"unsupported analytic potential {kind}")


def analytic_b(analytic, shape, ext: int, device=None, origin=(0, 0, 0)) -> torch.Tensor:
    """Interior B = 1/(1 + dt/2·(V − vshift)) in f32 from padded-index
    coordinates — the formula of ``pallas_stencil._analytic_b`` and of the
    kernel's ``analytic_b``. ``analytic`` = (kind, dn, dt, mass, ngx, ngy,
    ngz[, sig[, vshift]]); ``shape`` and ``origin`` as :func:`analytic_v`."""
    dt = analytic[2]
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    v = analytic_v(analytic, shape, ext, device, origin)
    return 1.0 / (1.0 + (0.5 * dt) * (v - vshift))


def x_windows(nx: int, origin, grid, red=None):
    """The x-plane windows of a sweep of a block of ``nx`` interior planes
    whose plane 0 is global plane ``origin[0]`` of a grid of extents
    ``grid``: ``(g0, g1)``, the planes inside the grid (the others, a deep
    x pad past a global face, are written zero), and ``(r0, r1)``, the
    planes the partial sums add: the window ``red`` (default all) inside
    ``(g0, g1)``."""
    g0, g1 = max(0, -origin[0]), min(nx, grid[0] - origin[0])
    r0, r1 = (0, nx) if red is None else red
    return (g0, g1), (max(r0, g0), min(r1, g1))


def sweep_step_plain(
    psi, out, coef, partials, *, order, scale, analytic=None, b_int=None,
    store=None, apply_coef=False, origin=(0, 0, 0), grid=None, red=None, done=None,
) -> None:
    """Plain torch version of :func:`sweep_step` (same arguments). It
    sweeps whatever ``done`` holds: reading the flag would synchronise the
    host, and a batch discards an idle chunk's output through its mask. A
    bf16 ``store`` is upcast to ψ's type, as K1 upcasts each value it reads."""
    ext = geometry.EXT[order]
    offsets, coeffs, center, _k = geometry.stencil_coefficients(order)
    n_store = 0 if store is None else store.shape[0]
    if store is not None:
        store = store.to(psi.dtype)
    block = tuple(d - 2 * ext for d in psi.shape)
    (g0, g1), (r0, r1) = x_windows(block[0], origin, _grid(analytic, grid, block, origin), red)
    c = psi
    if apply_coef:
        c = psi * coef[0]
        for s in range(n_store):
            c = c - coef[1 + s] * store[s]
    c0 = geometry.work_area(c, ext)
    acc = -center * c0
    for off, cf in zip(offsets, coeffs):
        for axis in range(3):
            acc = acc + cf * (shifted(c, ext, axis, off) + shifted(c, ext, axis, -off))
    b = b_int if analytic is None else analytic_b(analytic, psi.shape, ext, psi.device, origin)
    new = b * (2.0 * c0 + scale * acc) - c0
    new[:g0].zero_()  # planes outside the grid
    new[g1:].zero_()
    out.zero_()
    geometry.work_area(out, ext).copy_(new)
    if partials is not None:
        w = new[r0:r1]
        sums = [torch.sum((w * w).double())]
        sums += [
            torch.sum((geometry.work_area(store[s], ext)[r0:r1] * w).double())
            for s in range(n_store)
        ]
        partials.zero_()
        partials[0].copy_(torch.stack(sums))


def finish_coef_plain(partials, red, coef, *, done=None) -> None:
    """Plain torch version of :func:`finish_coef`; like
    :func:`sweep_step_plain` it ignores ``done``."""
    red.copy_(partials.sum(dim=0))
    inv = torch.rsqrt(torch.clamp(red[0], min=1e-37))
    coef.copy_(torch.cat([inv[None], red[1:] * inv]))


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def require_done(done, device) -> None:
    """A batch's flag: a 0-d int32 tensor on the launch's device."""
    _require(done, "done", torch.int32, (), device)


def _require(t, name, dtype, shape, device):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")


def _grid(analytic, grid, block, origin):
    """The global interior extents a block's ``origin`` refers to: those of
    ``analytic`` (which ``grid``, if given, must equal), else ``grid``, else
    the block's own reach from the origin (nothing outside the grid)."""
    if analytic is not None:
        ext = tuple(int(g) for g in analytic[4:7])
        if grid is not None and tuple(grid) != ext:
            raise ValueError(f"grid {tuple(grid)} is not the analytic grid size {ext}")
        return ext
    if grid is not None:
        return tuple(int(g) for g in grid)
    return tuple(o + n for o, n in zip(origin, block))


def check_origin(grid, block, origin, red=None, name="grid size") -> None:
    """The block of extents ``block`` at ``origin`` lies inside the global
    extents ``grid`` (``name`` in the message) along y and z; along x it
    may reach past the grid (a deep x pad, whose planes are written zero).
    ``red`` is a window of its interior x-planes."""
    if any(o < 0 or o + n > g for o, n, g in zip(origin[1:], block[1:], grid[1:])):
        raise ValueError(
            f"{name} {tuple(grid)} does not hold the "
            f"block {tuple(block)} at origin {tuple(origin)} along y and z"
        )
    if red is not None and not 0 <= red[0] <= red[1] <= block[0]:
        raise ValueError(f"reduction window {tuple(red)} is not inside 0..{block[0]}")


@functools.lru_cache(maxsize=4096)
def launch_geometry(analytic, grid, block, origin, red, kinds=tuple(KINDS),
                    what="analytic potential"):
    """The C arguments a K1/K3 launch takes from its B source and
    geometry: ``(kind, dn, dt, mass, sig, vshift, absorb, gnx, gny, gnz, ox,
    oy, oz, r0, r1)``, after the checks of :func:`check_origin` and of the
    kind (one of ``kinds``; ``what`` names them in the error). A chunk
    repeats a few geometries every step, so the checks run once each and a
    launch pays a cache lookup; the arguments must be hashable (tuples)."""
    g = _grid(analytic, grid, block, origin)
    check_origin(g, block, origin, red, "grid size" if analytic is None else "analytic grid size")
    where = (*g, *(int(o) for o in origin), *((0, block[0]) if red is None else map(int, red)))
    if analytic is None:
        return (_STREAMED, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, *where)
    if analytic[0] not in kinds:
        raise ValueError(f"unsupported {what} {analytic[0]}")
    dn, dt, mass = (float(x) for x in analytic[1:4])
    sig = float(analytic[7]) if len(analytic) > 7 else 0.0
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    absorb = float(analytic[9]) if len(analytic) > 9 else 0.0
    return (KINDS[analytic[0]], dn, dt, mass, sig, vshift, absorb, *where)


def _raise_if_failed(kernel: str, code: int) -> None:
    if code != 0:
        text = _build.library().wafer_error_string(code).decode()
        raise KernelLaunchError(kernel, code, text)


def num_partials(psi: torch.Tensor, order: str) -> int:
    """Rows of the partials scratch a sweep of ``psi`` writes: one per
    CUDA block, one for the plain version."""
    if _device_kind(psi) == "cpu":
        return 1
    ext = geometry.EXT[order]
    return _num_blocks(*(d - 2 * ext for d in psi.shape), ext)


@functools.lru_cache(maxsize=None)
def _num_blocks(nx: int, ny: int, nz: int, ext: int) -> int:
    return _build.library().wafer_sweep_num_blocks(nx, ny, nz, ext)


@functools.lru_cache(maxsize=None)
def _row_copy_widths(nz: int, ext: int, n_store: int, kind: int, bf16: bool):
    """The ROW_COPIES keys of a K1 launch from ψ at an address 0 and 4 past
    a multiple of 8 bytes, by the library's own rule ("0": no row copies)."""
    lib = _build.library()
    return tuple(str(lib.wafer_sweep_row_copy_bytes(at, nz, ext, n_store, kind, int(bf16)))
                 for at in (0, 4))


def sweep_step(
    psi: torch.Tensor,
    out: torch.Tensor,
    coef: torch.Tensor,
    partials: Optional[torch.Tensor],
    *,
    order: str,
    scale: float,
    analytic=None,
    b_int: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,
    apply_coef: bool = False,
    origin=(0, 0, 0),
    grid=None,
    red=None,
    done: Optional[torch.Tensor] = None,
) -> None:
    """K1: one sweep of padded ``psi`` into ``out`` (shell written zero).

    ``coef`` (1+S,) f32 holds [inv, corr_0..corr_{S-1}], read on the device
    and applied to the input when ``apply_coef``; ``store`` (S, *psi.shape)
    holds the lower states, f32 or bf16 (:func:`exc_stream_dtype`; K1 then
    reads the bf16 values and upcasts each to f32, and counts its launch as
    ``sweep_step_bf16``; every launch counts under its :func:`route`);
    ``partials`` (:func:`num_partials`, 1+S) f64
    receives the per-block sums of ‖ψ'‖² and ⟨lₛ|ψ'⟩, or is None for no
    reductions. B comes from ``analytic`` (the reference's tuple, with the
    global extents) at the block's ``origin`` in the global interior, or
    from the interior array ``b_int``. ``partials`` may be a row range of a
    larger buffer (a view with its own data pointer).

    A deep block (a shard's block with x pads ``R·ext`` deep, for windows
    of R steps between x exchanges) takes the global interior extents
    ``grid`` (those of ``analytic`` by default; for streamed B the block's
    reach) and may reach past them along x: its interior planes outside the
    grid are written zero and never summed. ``red = (r0, r1)`` restricts
    the partial sums to interior x-planes r0..r1-1 (the block's true
    interior); rows of CUDA blocks outside it hold zeros, so the row count
    stays :func:`num_partials`.

    ``done`` (a 0-d int32 tensor on the device, or None) is a batch's flag:
    while it holds a non-zero value the launch writes nothing, neither
    ``out`` nor ``partials`` (the chunks after a batch's convergence
    verdict). The flag is read on the device; None launches exactly as
    before the flag existed. Every call checks its tensors:
    :func:`bind_sweep` checks once and then only launches."""
    if _device_kind(psi) == "cpu":
        sweep_step_plain(
            psi, out, coef, partials, order=order, scale=scale, analytic=analytic,
            b_int=b_int, store=store, apply_coef=apply_coef, origin=origin, grid=grid, red=red,
        )
        return
    require_apart(psi, out, "sweep_step")
    bind_sweep(
        psi, coef, partials, order=order, scale=scale, analytic=analytic, b_int=b_int,
        store=store, apply_coef=apply_coef, origin=origin, grid=grid, red=red, done=done,
    )(psi, out)


def require_apart(psi, out, kernel) -> None:
    """A launch's ψ and output: contiguous f32 tensors of one shape on one
    device, not the same memory."""
    _require(psi, "psi", torch.float32, psi.shape, psi.device)
    _require(out, "out", torch.float32, psi.shape, psi.device)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError(f"{kernel} cannot run in place")


def stream_handle(dev: torch.device, stream: Optional[torch.cuda.Stream]) -> int:
    """The CUDA stream a bound launcher launches on: ``stream``, or the
    device's current stream when the launcher is made."""
    return (stream if stream is not None else torch.cuda.current_stream(dev)).cuda_stream


def on_device(dev: torch.device, fn, *args) -> int:
    """``fn(*args)`` with ``dev`` the current CUDA device (a mesh's blocks
    may lie on several)."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def bind_sweep(
    like: torch.Tensor,
    coef: torch.Tensor,
    partials: Optional[torch.Tensor],
    *,
    order: str,
    scale: float,
    analytic=None,
    b_int: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,
    apply_coef: bool = False,
    origin=(0, 0, 0),
    grid=None,
    red=None,
    done: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
) -> Callable[[torch.Tensor, torch.Tensor], None]:
    """K1 bound to everything but its ψ and output: the checks of
    :func:`sweep_step` and the launch geometry run here once, against
    ``like`` (a tensor of ψ's shape, type and device), and each call
    ``launch(src, dst)`` launches the kernel on ``stream`` (default: the
    current stream now), or raises. The caller keeps ``src`` and ``dst``
    like ``like`` and apart: a chunk's own buffers, or a ψ it checked once.
    The launcher holds its tensors (``launch.tensors``), so every pointer
    it launches with stays valid while it lives. On CPU tensors the call
    runs the plain version. Arguments as :func:`sweep_step`."""
    if _device_kind(like) == "cpu":
        def plain(src, dst):
            sweep_step_plain(
                src, dst, coef, partials, order=order, scale=scale, analytic=analytic,
                b_int=b_int, store=store, apply_coef=apply_coef, origin=origin, grid=grid,
                red=red,
            )
        return plain
    ext = geometry.EXT[order]
    dev = like.device
    f32 = torch.float32
    if like.dim() != 3:
        raise ValueError("psi must be a padded 3-D array")
    nx, ny, nz = (d - 2 * ext for d in like.shape)
    _require(like, "psi", f32, like.shape, dev)
    n_store = 0 if store is None else store.shape[0]
    bf16 = n_store > 0 and store.dtype == torch.bfloat16
    if store is not None:
        _require(store, "store", torch.bfloat16 if bf16 else f32, (n_store, *like.shape), dev)
        if bf16 and store.data_ptr() % 4:
            raise ValueError("a bf16 store must start on a 4-byte boundary")
    _require(coef, "coef", f32, (1 + n_store,), dev)
    if partials is not None:
        _require(partials, "partials", torch.float64,
                 (num_partials(like, order), 1 + n_store), dev)
    kind, dn, dt, mass, sig, vshift, _absorb, *where, r0, r1 = launch_geometry(
        analytic, grid, (nx, ny, nz), origin, red)
    if analytic is None:
        _require(b_int, "b_int", f32, (nx, ny, nz), dev)
    if done is not None:
        require_done(done, dev)
    fn = _build.library().wafer_sweep_step
    args = (
        None if b_int is None or analytic is not None else b_int.data_ptr(),
        None if store is None else store.data_ptr(),
        coef.data_ptr(),
        None if partials is None else partials.data_ptr(),
        nx, ny, nz, ext, n_store, int(apply_coef), float(scale),
        kind, *where, dn, dt, mass, sig, vshift, r0, r1,
        None if done is None else done.data_ptr(), int(bf16), stream_handle(dev, stream),
    )
    name = route(False, n_store, bf16)
    widths = _row_copy_widths(nz, ext, n_store, kind, bf16)

    def launch(src: torch.Tensor, dst: torch.Tensor) -> None:
        code = on_device(dev, fn, src.data_ptr(), dst.data_ptr(), *args)
        _raise_if_failed("sweep_step", code)
        LAUNCHES[name] += 1
        if widths[0] != "0":
            ROW_COPIES[widths[src.data_ptr() % 8 // 4]] += 1

    launch.tensors = (coef, partials, b_int, store, done)
    return launch


# K2's launch shape (csrc/finish_coef.cu): a thread loads 4 rows before
# adding them. One block of 512 threads adds up to FINISH_ONE_BLOCK doubles
# (rows × n_red), since its time grows with the bytes it reads; above that,
# groups of 256 threads take about FINISH_GROUP rows each (one round of
# loads), at most FINISH_MAX_GROUPS of them, and the hand-over to the last
# group costs about as much as one block reading 16,384 doubles. Chosen from
# times on an H100 (tools/tune_finish.py, chip_smoke.py phase 2e).
FINISH_ONE_BLOCK = 16384
FINISH_GROUP = 1024
FINISH_MAX_GROUPS = 256


def finish_groups(n_blocks: int, n_red: int) -> int:
    """Blocks of K2 that share ``n_blocks`` partial rows of ``n_red`` columns."""
    if n_blocks * n_red <= FINISH_ONE_BLOCK:
        return 1
    return min(FINISH_MAX_GROUPS, -(-n_blocks // FINISH_GROUP))


def finish_launcher(partials: torch.Tensor, red: torch.Tensor, coef: torch.Tensor, *,
                    done: Optional[torch.Tensor] = None,
                    stream: Optional[torch.cuda.Stream] = None) -> Callable[[], None]:
    """K2 bound to these tensors: the checks of :func:`finish_coef` run
    once, and each call of the returned function launches the kernel on
    ``stream`` (default: the stream current now), or raises. A chunk makes it once and calls it
    every step. The launcher owns K2's scratch (``launch.scratch``), made
    zeroed here: the ticket of the last block, which each launch leaves
    zero for the next, and one row of sums a group, f64 ``(1 + G·n_red,)``;
    it holds ``launch.tensors``, so every pointer it launches with stays
    valid while it lives. ``done``, a batch's flag as in :func:`sweep_step`:
    while it is set a launch returns before it reads a row or takes the
    ticket. The stream is bound here, so a launcher made outside a CUDA
    graph's capture launches outside the graph: a captured chunk makes its
    own for the capture's stream (its scratch zeroed outside the graph). On
    CPU tensors the call runs the plain version."""
    kind = _device_kind(partials)
    dev = partials.device
    if partials.dim() != 2:
        raise ValueError("partials must be (n_blocks, 1+S)")
    n_blocks, n_red = partials.shape
    _require(partials, "partials", torch.float64, (n_blocks, n_red), dev)
    _require(red, "red", torch.float64, (n_red,), dev)
    _require(coef, "coef", torch.float32, (n_red,), dev)
    if kind == "cpu":
        return functools.partial(finish_coef_plain, partials, red, coef)
    if done is not None:
        require_done(done, dev)
    groups = finish_groups(n_blocks, n_red)
    scratch = torch.zeros(1 + groups * n_red, dtype=torch.float64, device=dev)
    fn = _build.library().wafer_finish_coef
    args = (partials.data_ptr(), n_blocks, n_red, red.data_ptr(), coef.data_ptr(),
            scratch.data_ptr(), groups, None if done is None else done.data_ptr(), dev.index,
            stream_handle(dev, stream))

    def launch() -> None:
        _raise_if_failed("finish_coef", fn(*args))
        LAUNCHES["finish_coef"] += 1

    launch.scratch = scratch
    launch.tensors = (partials, red, coef, scratch, done)
    return launch


def finish_coef(partials: torch.Tensor, red: torch.Tensor, coef: torch.Tensor, *,
                done: Optional[torch.Tensor] = None) -> None:
    """K2: ``red`` (1+S,) f64 ← the partials summed over blocks in a fixed
    order; ``coef`` (1+S,) f32 ← [rsqrt(max(red₀, 1e-37)), redₛ·inv];
    nothing while a batch's flag ``done`` is set (:func:`finish_launcher`)."""
    finish_launcher(partials, red, coef, done=done)()


# --------------------------------------------------------------------------- #
# the chunk loop
# --------------------------------------------------------------------------- #


def evolve_chunk(
    phi: torch.Tensor,
    order: str,
    dt: float,
    dn: float,
    mass: float,
    n_steps: int,
    analytic=None,
    per_step_norm: bool = False,
    store: Optional[torch.Tensor] = None,
    b_int: Optional[torch.Tensor] = None,
    done: Optional[torch.Tensor] = None,
    graphs: Optional[chunk_graph.ChunkGraphs] = None,
) -> torch.Tensor:
    """``n_steps`` sweeps entirely on the device: the counterpart of
    ``pallas_stencil.evolve_chunk_resident`` and of the functions that
    compute the same chunk with another TPU residency scheme:
    ``evolve_chunk_fused`` (1-step sweeps), ``evolve_chunk_fused_k`` (K
    ground steps per HBM pass, B5), ``evolve_chunk_resident_blocked`` (R
    deep-halo ground steps per x-block, B6) and ``evolve_chunk_fused_kgs``
    (two per-step normalise-and-project steps per pass with the correction
    deferred through Gram matrices, B4; exact in exact arithmetic). On the
    card one K1 (+ K2) launch per step, at every grid size, computes each
    of them: there is no VMEM to stay inside, so the chunk needs no
    picker.

    Ground state: K1 per step, no reductions. ``per_step_norm`` (the f32
    drift guard) and stored states ``store`` (S, *phi.shape; f32, or bf16
    streams by :func:`exc_stream_dtype`) run K2 after
    every K1, which carries the reference's exact per-step
    normalise-then-project recursion (src/grid.rs:674-681) in ``coef``;
    the last step's pending correction is applied here as plain tensor
    ops, as pallas_stencil.py:2962-2970 does. ``phi`` is not modified.
    With a batch's flag ``done`` set (:func:`sweep_step`) no launch writes,
    and the result is undefined: the batch keeps ψ through its mask.

    The steps run on a :class:`DeviceChunk` (``chunk_graph.run``): made
    for this call, or with ``graphs`` (a solve's
    :class:`~wafer_torch.chunk_graph.ChunkGraphs`; not with ``done``) kept
    by key and, on its graph route, replayed from a captured segment."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = dt / (k * dn * dn * mass)
    if analytic is None and b_int is None:
        raise ValueError("evolve_chunk needs either analytic or b_int")

    def make():
        return DeviceChunk(phi, order, scale, analytic=analytic, b=b_int, store=store,
                           per_step_norm=per_step_norm, done=done)

    if graphs is None or done is not None:
        return chunk_graph.run(make(), phi, n_steps)
    key = ("K1", order, tuple(phi.shape), phi.device, scale, per_step_norm,
           *store_key(store), *b_key(analytic, b_int))
    return graphs.run(key, make, phi, n_steps)


def store_key(store) -> tuple:
    """A bound chunk's key for its stored states: their count, type and
    memory (a solve's store lives as long as its state)."""
    if store is None or store.shape[0] == 0:
        return (0, None, None)
    return (store.shape[0], store.dtype, store.data_ptr())


def b_key(analytic, b) -> tuple:
    """A bound chunk's key for its B: the analytic tuple, or the streamed
    array's memory."""
    return ("analytic", analytic) if analytic is not None else ("streamed", b.data_ptr())


class DeviceChunk:
    """The bound chunk of one device (``chunk_graph``'s notes): ψ's two
    buffers, the coefficients, the reductions and K1 and K2 bound to them
    (``hopper_split.PairChunk``: K3 on (re, im) pairs). ``like`` gives ψ's
    shape, type and device; the other arguments are :func:`evolve_chunk`'s,
    ``b`` its ``b_int``."""

    period = 1
    components = 1  # reductions a stored state adds
    bind = staticmethod(bind_sweep)
    rows = staticmethod(num_partials)
    b_name = "b_int"

    def __init__(self, like, order, scale, *, analytic=None, b=None, store=None,
                 per_step_norm=False, done=None):
        self.per_step_norm = per_step_norm
        self.store = store if store is not None and store.shape[0] > 0 else None
        n_store = 0 if self.store is None else store.shape[0]
        self.reduce = per_step_norm or n_store > 0
        dev = like.device
        n_red = 1 + self.components * n_store
        self.coef = torch.empty(n_red, dtype=torch.float32, device=dev)
        self.partials = self.red = None
        if self.reduce:
            self.partials = torch.empty(self.rows(like, order), n_red, dtype=torch.float64,
                                        device=dev)
            self.red = torch.empty(n_red, dtype=torch.float64, device=dev)
        self.bufs = (torch.empty_like(like), torch.empty_like(like))
        self.device, self.counts = dev, LAUNCHES
        self.tensors = (store, b)
        self.done = done
        self._sweep = functools.partial(
            self.bind, like, self.coef, self.partials, order=order, scale=scale,
            analytic=analytic, store=store, apply_coef=self.reduce, done=done,
            **{self.b_name: b})
        self.eager = self.launchers()

    def launchers(self, stream=None):
        """(the sweep, K2 or None) bound to this chunk's tensors, launching
        on ``stream`` (default: the current stream)."""
        finish = None
        if self.reduce:
            finish = finish_launcher(self.partials, self.red, self.coef, done=self.done,
                                     stream=stream)
        return self._sweep(stream=stream), finish

    def begin(self, phi):
        """A chunk's set-up: ψ checked once, and the identity coefficients
        (the first step sweeps ψ as it is); step 0 reads ψ itself."""
        like = self.bufs[0]
        if phi.shape != like.shape or phi.dtype != like.dtype or phi.device != like.device:
            raise ValueError(f"the chunk's ψ is {phi.dtype} {tuple(phi.shape)} on "
                             f"{phi.device}, its buffers {like.dtype} {tuple(like.shape)}")
        if phi.is_cuda:
            require_apart(phi, like, "a chunk")
        self.coef.zero_()
        self.coef[:1].fill_(1.0)
        return phi

    def step(self, launch, t, src, dst) -> None:
        sweep, finish = launch
        sweep(src, dst)
        if finish is not None:
            finish()

    def fresh(self):
        return torch.empty_like(self.bufs[0])

    def end(self, last):
        return self.finish_chunk(last, self.coef, self.store, self.per_step_norm)

    @staticmethod
    def finish_chunk(src, coef, store, per_step_norm):
        return finish_chunk(src, coef, store, per_step_norm)


def finish_chunk(src, coef, store, per_step_norm: bool) -> torch.Tensor:
    """The last step's pending coefficients applied to the sweep's output:
    ψ·inv − Σₛ corrₛ·lₛ with stored states (a bf16 stream upcast to ψ's type, as
    the reference's f32-promoting ``tensordot`` of pallas_stencil.py:2966-2970
    does), ψ·inv for a per-step-norm chunk, ψ as it is for a ground chunk."""
    if store is not None and store.shape[0] > 0:
        return src * coef[0] - torch.tensordot(coef[1:], store.to(src.dtype), dims=1)
    if per_step_norm:
        return src * coef[0]
    return src
